"""Evaluation of the refiner over benchmark datasets (port of
quber_tpu/evaluation): dataset walkers, base segmenters, refiner wrappers,
Overlap / Boundary P/R/F metrics and the harness, all without OpenCV."""
