"""Readers of the Waymo scene lists (the pure readers of
``emernerf_tpu/tools/download_waymo.py``; the downloader itself needs the
network and is not ported)."""

from __future__ import annotations


def read_scene_list(path: str):
    """waymo_train_list.txt: one TFRecord basename per line, index = scene id."""
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def read_split_file(path: str):
    """NOTR split csv: 'scene_id,seg_name,start,end,type' per line."""
    ids = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            ids.append(int(line.split(",")[0]))
    return ids
