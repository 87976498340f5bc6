"""Command-line tools of the port: the KITTI-layout fixture writer, the
full-budget quality runs, the depth-prior generator and trainer, and the
prior -> NeRF chain."""
