"""Command-line tools of the port: the KITTI-layout fixture writer and the
full-budget quality runs."""
