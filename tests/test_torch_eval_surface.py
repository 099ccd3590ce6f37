"""The port's evaluation outputs against the JAX package's, written files
included: ``eval/video.py:save_videos`` (the gif route where imageio has
no ffmpeg backend, the png of a single timestamp, one video per key) and
``eval/data_preview.py:render_data_video`` on the tiny flagship scene.
Both packages write through the same imageio, so the decoded frames must
be equal, bit for bit.
"""

import imageio.v2 as imageio
import numpy as np
import pytest

from emernerf_tpu.builders import build_dataset_from_cfg as jax_build_dataset
from emernerf_tpu.eval import data_preview as jax_data_preview
from emernerf_tpu.eval import video as jax_video
from emernerf_tpu.flagship import flagship_config as jax_flagship_config
from emernerf_torch.builders import build_dataset_from_cfg
from emernerf_torch.eval import data_preview, video
from emernerf_torch.flagship import flagship_config


def _frames(n, h=8, w=12, seed=0):
    rng = np.random.default_rng(seed)
    return [{"rgb": rng.uniform(0, 1, (h, w, 3)).astype(np.float32),
             "depth": rng.uniform(1, 50, (h, w)).astype(np.float32),
             "opacity": rng.uniform(0, 1, (h, w)).astype(np.float32),
             "forward_flow": rng.normal(size=(h, w, 3)).astype(np.float32)}
            for _ in range(n)]


def _read(path):
    return np.stack(list(imageio.mimread(path))) if path.endswith(".gif") else imageio.imread(path)


@pytest.mark.parametrize("case", ["video", "one_timestamp", "per_key"])
def test_save_videos_matches_jax(tmp_path, case):
    """Two cameras of three timesteps side by side (one timestep: a png),
    three keys stacked, or one file per key."""
    n_t = 1 if case == "one_timestamp" else 3
    frames = _frames(2 * n_t)
    kw = dict(keys=["rgb", "depth", "forward_flow"], num_timestamps=n_t, fps=4, num_cams=2,
              save_seperate_video=case == "per_key")
    ours = video.save_videos(frames, str(tmp_path / "ours" / "v.mp4"), **kw)
    ref = jax_video.save_videos(frames, str(tmp_path / "ref" / "v.mp4"), **kw)
    names = sorted(p.name for p in (tmp_path / "ref").iterdir())
    assert sorted(p.name for p in (tmp_path / "ours").iterdir()) == names and names
    assert ours.replace("ours", "ref") == ref
    for name in names:
        a, b = _read(str(tmp_path / "ours" / name)), _read(str(tmp_path / "ref" / name))
        np.testing.assert_array_equal(a, b, err_msg=name)
    if case == "one_timestamp":
        assert names == ["v.png"] and a.shape == (3 * 8, 2 * 12, 3)


def test_render_data_video_matches_jax(tmp_path):
    """The tiny flagship scene's data video: gt rgb, projected lidar depth,
    lidar flow and the masks, one row each."""
    dot = ["data.pixel_source.load_dynamic_mask=true"]
    ours = data_preview.render_data_video(
        build_dataset_from_cfg(flagship_config(tiny=True, overrides=dot)),
        str(tmp_path / "ours" / "data.mp4"), fps=2)
    ref = jax_data_preview.render_data_video(
        jax_build_dataset(jax_flagship_config(tiny=True, overrides=dot)),
        str(tmp_path / "ref" / "data.mp4"), fps=2)
    a, b = _read(ours), _read(ref)
    assert a.shape[0] == 3 and a.shape[1] >= 4 * 16
    np.testing.assert_array_equal(a, b)
