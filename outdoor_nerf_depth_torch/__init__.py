"""outdoor_nerf_depth_torch: the PyTorch/CUDA port of outdoor_nerf_depth.

A second implementation of the depth-supervised outdoor NeRF framework,
written for one NVIDIA Hopper GPU. The TPU package in this repository is its
reference: every module here keeps that package's module names, public
functions and numerics, and the tests hold the two against each other on the
CPU. Kernels that the TPU package wrote in Pallas are hand-written CUDA C++
under `csrc/`, built with nvcc at first use.

Layout:
  ops/       tensor math: step functions, coordinate warps, volume rendering,
             and the CUDA compositing-weights kernel (`ops/volren_weights.py`)
  models/    the mip-NeRF 360 proposal model and its cone-field MLPs
  data/      rays, cameras, the synthetic dataset and the prefetching batcher
  train/     config, losses, metrics, the train step and the train loop
  depth_priors/  the stereo and completion nets that generate depth priors,
             their datasets, and the writer of the prior PNGs
  tools/     the fixture writer, quality runs and the depth-prior tools
  convert.py loads a Flax parameter tree (as numpy) into the torch model

Entry points run on CUDA unless the caller passes `device="cpu"`.
"""

__version__ = "0.1.0"
