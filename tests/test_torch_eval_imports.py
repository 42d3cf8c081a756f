"""The port needs none of OpenCV, imageio, Pillow, `regex`, JAX or the JAX
package: a fresh interpreter in which importing any of them fails imports
every module of quber_tpu_torch and the port's scripts, and runs run_eval
(the foreground filter included), tiny SAM wrappers (the mask-prompted
refiner and the automatic generator on the depth), the Detic wrapper with
CLIP's tokenizer (the committed mini merges file) and a small CLIP text
tower, predict_torch.py and demo_torch.py on one small frame on the CPU,
the file-backed training path (the offline tools, the mapper with its
augmentation, one step of train_net_torch.py and of train_fg_torch.py) and
one train_eee step of the late-fusion model, and the reference-checkpoint
seam: the parity drill on a seeded flagship and the import CLI."""

import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import importlib, pkgutil, sys, tempfile
    for name in ("cv2", "imageio", "PIL", "regex", "jax", "jaxlib", "flax", "quber_tpu"):
        sys.modules[name] = None  # any import of it now raises ImportError

    import torch
    torch.set_num_threads(2)
    import quber_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(quber_tpu_torch.__path__, "quber_tpu_torch.")]
    for name in names + ["run_eval_torch", "train_net_torch", "chip_smoke", "bench_torch",
                         "predict_torch", "demo_torch", "train_zoo_torch", "train_fg_torch"]:
        importlib.import_module(name)

    from quber_tpu_torch.data.make_synthetic_dataset import main as make_dataset
    from quber_tpu_torch.evaluation.harness import run_eval
    from quber_tpu_torch.models.mask_refiner import MaskRefinerConfig

    with tempfile.TemporaryDirectory() as tmp:
        make_dataset(["--out", tmp + "/osd", "--n", "1", "--height", "48", "--width", "64"])
        cfg = MaskRefinerConfig(height=96, width=128, resnet_depth=14)
        res = run_eval(base_model="perturbed-gt", refiner_model="maskrefiner",
                       dataset_path=tmp + "/osd", config=cfg, csv_path=tmp + "/x.csv",
                       device="cpu")
        assert set(res) >= {"initial", "refined", "seconds"}, res
        assert res["seconds"]["fg"] > 0

        import numpy as np
        import demo_torch
        import predict_torch
        from quber_tpu_torch.evaluation.base_models import GT

        rgb = tmp + "/osd/image_color/synth_00000.png"
        depth = rgb.replace("image_color", "disparity")
        np.save(tmp + "/masks.npy", GT("OSD").predict(rgb, depth)[0])
        # SAM's refiner and automatic generator (on the depth), tiny models
        from quber_tpu_torch.models.sam_refiner import SAMAutomaticBaseModel, SAMHQRefiner

        tiny = dict(img_size=64, embed_dim=32, depth=2, num_heads=2, device="cpu")
        sam = SAMHQRefiner(global_blocks=(1,), window_size=3, **tiny)
        out = sam.predict(rgb, depth, GT("OSD").predict(rgb, depth)[0], None)
        assert out[0].shape[1:] == (480, 640), out[0].shape
        out = SAMAutomaticBaseModel(depth_input=True, **tiny).predict(rgb, depth)
        assert out[0].shape[1:] == (480, 640), out[0].shape
        # the open-vocabulary wrapper with CLIP's tokenizer and text tower
        from quber_tpu_torch.models.open_vocab import DeticBaseModel

        clip = dict(vocab_size=524, width=32, layers=1, heads=2, context_length=16,
                    embed_dim=256)
        detic = DeticBaseModel(bpe_path="tests/fixtures/clip_mini_merges.txt",
                               clip_config=clip, device="cpu")
        assert detic.text_embeds.shape == (13, 256)
        out = detic.predict(rgb, depth)
        assert out[0].shape[1:] == (480, 640), out[0].shape
        # one step of the late-fusion error-estimation model
        import itertools

        from quber_tpu_torch.models.late_fusion import MODALITIES, LateFusionEncoderDecoder
        from quber_tpu_torch.train.eee_train import train_eee

        batch = {k: torch.rand(1, c, 16, 16) for k, c in MODALITIES}
        batch["mask_target"] = batch["boundary_target"] = torch.rand(1, 3, 16, 16)
        _, m = train_eee(LateFusionEncoderDecoder(), itertools.repeat(batch), 1, log_every=0,
                         device="cpu")
        assert torch.isfinite(m["total_loss"])
        with open(tmp + "/small.yaml", "w") as f:  # the int8 weights at 96x128
            f.write("model:\\n  height: 96\\n  width: 128\\n")
        common = ["--config-file", tmp + "/small.yaml", "--device", "cpu"]
        assert predict_torch.main(["--rgb", rgb, "--depth", depth, "--masks",
                                   tmp + "/masks.npy", "--out", tmp + "/p.png"] + common) == 0
        assert demo_torch.main(["--input", rgb, "--depth-dir", tmp + "/osd/disparity",
                                "--output", tmp + "/vis"] + common) == 0
        # training from files: the tools, the mapper with SSD colour and
        # Perlin, a device-target step and a foreground step
        import train_fg_torch
        import train_net_torch
        from quber_tpu_torch.data.make_uoais_sim import make as make_uoais

        make_uoais(tmp + "/osd", tmp + "/uoais")
        with open(tmp + "/tiny.yaml", "w") as f:
            f.write("model:\\n  height: 32\\n  width: 32\\n  resnet_depth: 14\\n"
                    "train:\\n  batch_size: 1\\n  max_iter: 1\\n")
        train_net_torch.main(["--config-file", tmp + "/tiny.yaml", "--dataset",
                              "uoais_sim_train_panoptic", "--data-root", tmp + "/uoais",
                              "--device-targets", "--device", "cpu", "--output-dir",
                              tmp + "/train"])
        assert train_fg_torch.main(["--model", "cgnet", "--dataset-path", tmp + "/osd",
                                    "--max-iter", "1", "--batch", "1", "--device", "cpu",
                                    "--output-dir", tmp + "/fg"]) == 0
        # the reference-checkpoint seam: the parity drill on a seeded flagship
        # in the detectron2 layout, and the import CLI
        from quber_tpu_torch.tools import activation_parity, import_checkpoint, parity_drill

        torch.save(activation_parity.random_state_dict(MaskRefinerConfig(), 0), tmp + "/m.pth")
        assert parity_drill.main(["--torch", tmp + "/m.pth", "--device", "cpu",
                                  "--parity-size", "32", "32", "--eval-size", "96", "128",
                                  "--dataset-path", tmp + "/osd", "--limit", "1",
                                  "--workdir", tmp + "/drill", "--out", tmp + "/drill.json"]) == 0
        assert import_checkpoint.main(["--torch", tmp + "/m.pth", "--out", tmp + "/imported",
                                       "--device", "cpu"]) == 0
    bad = [m for m in ("cv2", "imageio", "PIL", "regex", "jax", "quber_tpu")
           if sys.modules.get(m)]
    assert not bad, bad
    print("OK", len(names))
""")


def test_port_runs_without_opencv_imageio_pillow_or_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    assert "OK" in out.stdout
