"""The benchmark of the PyTorch/CUDA port (`outdoor_nerf_depth_torch`); see README.md."""
