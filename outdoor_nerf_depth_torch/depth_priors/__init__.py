"""Depth-prior generators: cost-volume stereo and depth completion.

Port of the reference package's `depth_priors/`: CFNet/PCWNet-style stereo
(`stereo.py`, the `stereo_crop` and confidence-filtered `ste_conf` priors),
std2019 and MFF-Net-style completion (`completion.py`, the `mff_crop`
priors), their shared blocks, training datasets, the stereo benchmark
readers, and `generate.py`, which writes the uint16 depth PNGs the NeRF
data layer reads. The nets are `torch.nn.Module`s; the convolutions are
cuDNN's through `torch.nn.functional`.
"""
