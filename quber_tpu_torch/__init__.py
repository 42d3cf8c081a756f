"""PyTorch/CUDA port of quber_tpu, held against the JAX package as reference.

The port imports torch, never JAX, and nothing of `quber_tpu`. Public
functions keep the JAX package's layouts (image [H, W, 6], masks [N, H, W],
encoding [3, H, W], offsets [2, H, W], centers [K, 2] int32 (y, x)) so the
two can be compared output for output; the modules inside are NCHW.

Ported so far: refinement inference, `predictor.MaskRefinerPredictor`
(single-frame `predict`, batched `predict_batch`, staged and streamed
serving) and `predictor.MultiScalePredictor`, with the encode and group
kernels and their batched launches hand-written in CUDA for sm_90a
(`ops/csrc/kernels.cu`); and training on rendered synthetic scenes (`train/`:
losses, device-side targets through the same kernels, Adam + WarmupPolyLR,
checkpoints), driven by `train_net_torch.py`; and evaluation over benchmark
datasets (`evaluation/`: walkers, base models, the refiner wrapper with the
CGNet / LMFFNet foreground filter, metrics, harness), driven by
`run_eval_torch.py`, with PNG files, resizes and Telea inpainting in numpy
in place of OpenCV and imageio (`data/png.py`, `ops/preprocess.py`); the
forward in float32 or bfloat16 (`models/`); and the serving benchmark and
the single-image and demo CLIs (`bench_torch.py`, `predict_torch.py`,
`demo_torch.py`). The training tensors (batch, targets, losses) are channels
first.
"""
