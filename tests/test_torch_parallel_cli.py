"""train_net_torch.py data-parallel without --multihost: two gloo ranks
under torchrun on the CPU, batch_size the global batch, against the same
CLI in one process; and the loader's rank shards.

tests/test_torch_train.py's tiny config (32x32, depth 14) with dropout 0
and a global batch of 4. The device pool gives each rank its half of the
same shuffled indices, the host route maps only the rank's half of each
batch: the losses (metrics.jsonl, unrounded) equal one process's, rtol 1e-4
at step 1 and 1e-3 after (Adam's first update is lr * sign(g): where g is ~0
the two computations may move a weight by 2 lr apart), and so do Adam's
first moments in step 2's checkpoint, within 15% of each tensor's norm as
in tests/test_torch_train.py, but for the conv biases ahead of a BatchNorm,
whose gradient is zero (the losses alone would not see two ranks each
taking the whole batch, which the global normalisers make the same step:
the CLI's first step reports rank 0's batch, half the global one). Later
moments are not compared: step 3's gradient, from states that differ by
those sign flips, moves by half its norm in this tiny net.
--resume restores the two ranks from rank 0's checkpoint and goes on as one
process does.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from quber_tpu_torch.config import load_any_config
from quber_tpu_torch.data.pipeline import WorkerLoader, make_dataloader
from quber_tpu_torch.models.layers import BatchNorm, ConvNorm
from quber_tpu_torch.train.checkpoint import restore_state
from quber_tpu_torch.train.loop import create_train_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = ("model:\n  height: 32\n  width: 32\n  resnet_depth: 14\n  aspp_dropout: 0.0\n"
        "train:\n  batch_size: 4\n  warmup_iters: 2\n  base_lr: 0.0005\n")
RTOLS = (1e-4, 1e-3, 1e-3)


@pytest.fixture
def scratch(tmp_path):
    """tmp_path, emptied after the test: the runs' checkpoints take ~1 GB."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _args(tmp_path, out, route, max_iter):
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(YAML)
    return ["--synthetic", "--synthetic-size", "6", "--target-slots", "8", "--device", "cpu",
            "--log-period", "1", "--max-iter", str(max_iter), "--config-file", str(cfg),
            "--output-dir", str(out), *route]


def _torchrun(args):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                          "--nproc-per-node", "2", os.path.join(REPO, "train_net_torch.py"),
                          *args], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert "world size 2" in res.stdout
    return res.stdout


def _local_batch(log):
    """The first step's batch on rank 0, from the CLI's [timing] line."""
    return int(log.split("local_batch=")[1].split()[0])


def _metrics(out):
    return [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]


def _assert_same_losses(got, want):
    assert [g["iter"] for g in got] == [w["iter"] for w in want]
    for g, w in zip(got, want):
        for k, v in w.items():
            assert g[k] == pytest.approx(v, rel=RTOLS[w["iter"] - 1]), (w["iter"], k)


@pytest.mark.parametrize("route", [["--device-targets"], []], ids=["device_pool", "host"])
def test_two_ranks_train_the_global_batch(scratch, route):
    import train_net_torch

    one, two = scratch / "one", scratch / "two"
    train_net_torch.main(_args(scratch, one, route, 2))
    if route:  # two steps, a checkpoint, then --resume for the third
        train_net_torch.main(_args(scratch, one, route, 3) + ["--resume"])
        assert _local_batch(_torchrun(_args(scratch, two, route, 2))) == 2
        assert os.path.exists(two / "ckpt" / "2" / "COMPLETE")
        log = _torchrun(_args(scratch, two, route, 3) + ["--resume"])
        assert "resumed at step 2" in log and "iter 3/3" in log
        assert log.count("resumed at step") == 1  # rank 0 alone logs
    else:
        assert _local_batch(_torchrun(_args(scratch, two, route, 2))) == 2
    _assert_same_losses(_metrics(two), _metrics(one))
    moments = []
    for out in (one, two):
        state = create_train_state(*load_any_config(str(scratch / "tiny.yaml")), device="cpu")
        assert restore_state(str(out / "ckpt"), state, step=2).step == 2
        names = {p: n for n, p in state.model.named_parameters()}
        moments.append({names[p]: s["exp_avg"] for p, s in state.optimizer.state.items()})
    skip = {f"{n}.conv.bias" for n, m in state.model.named_modules()
            if isinstance(m, ConvNorm) and isinstance(m.norm, BatchNorm)}
    want, got = moments
    assert len(want) - len(skip) > 100
    for name, m in want.items():
        if name not in skip:
            assert float((got[name] - m).norm()) <= 0.15 * float(m.norm()), name


class _Drawing:
    """A mapper that draws from its `rng`, as an augmenting one does."""

    def __init__(self):
        self.rng = np.random.RandomState(0)

    def __call__(self, record):
        return {"x": np.asarray([record, self.rng.rand()], np.float64)}


def test_rank_shards_are_the_single_process_batches_sliced():
    """make_dataloader(shard=(rank, 2)): each rank maps only its half of each
    global batch, with the draws of the sample's stream position, so the
    ranks' batches side by side are the one-process position-seeded loader's
    batches; an odd global batch is refused."""
    records = list(range(7))
    whole = WorkerLoader(records, _Drawing(), 4, seed=3, worker_count=0)
    shards = [make_dataloader(records, _Drawing(), 4, seed=3, shard=(r, 2)) for r in range(2)]
    for _ in range(4):  # past an epoch's end
        want = next(whole)["x"]
        got = np.concatenate([next(s)["x"] for s in shards])
        assert np.array_equal(got, want)
    with pytest.raises(ValueError, match="divide"):
        make_dataloader(records, _Drawing(), 3, shard=(0, 2))


def test_multihost_refusals(monkeypatch):
    """--multihost needs torchrun's environment, and --no-data-device-cache
    (the device pool holds one global order of samples, --multihost's
    streams are the ranks' own), as train_net.py refuses it."""
    import train_net_torch

    argv = ["--multihost", "--synthetic", "--device-targets", "--device", "cpu"]
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(SystemExit, match="torchrun"):
        train_net_torch.main(argv)
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    with pytest.raises(SystemExit, match="--no-data-device-cache"):
        train_net_torch.main(argv)
