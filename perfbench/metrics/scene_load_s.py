"""Seconds the port takes to build the train dataset from the written scene
(`train/loop.py:build_dataset`: PNG decode, COLMAP read, pose normalization)."""


def read(run, measured):
    return measured.counters.get("scene_load_s")
