"""Small conveniences (port of svgpvae_tpu/utils/misc.py).

  * `dict_to_flags` -- dict -> " --k v" CLI string for programmatic
    sweeps;
  * `save_video_frames` -- each frame of one video as a PNG (180 x 180,
    the JAX package's 3-inch figure at dpi 60), drawn with numpy alone
    (utils.plots).
"""

from __future__ import annotations

import os

import numpy as np

from svgpvae_tpu_torch.utils import plots


def dict_to_flags(d: dict) -> str:
    cmd = ""
    for k, v in d.items():
        cmd += f" --{k} {v}"
    return cmd


def save_video_frames(vid_batch, out_dir: str, index: int = 0,
                      max_frames: int = 30) -> str:
    """Save frames of vid_batch[index] as frame_<t>.png under out_dir
    ('Greys', origin lower, axis off); returns the directory written."""
    os.makedirs(out_dir, exist_ok=True)
    vid = np.asarray(vid_batch[index])
    for t in range(min(len(vid), max_frames)):
        cv = plots.Canvas((3, 3), dpi=60)
        (box,) = cv.subplots(1, 1)
        plots.image_panel(cv, box, plots.apply_colormap(vid[t], "Greys"),
                          "lower", axis=False)
        cv.finish(os.path.join(out_dir, f"frame_{t:03d}.png"))
    return out_dir
