"""The port's test files share one reader of a run dir's pictures: every
pics/*.png decoded by utils.png.read_png (the port's own writer's
format), each checked to be a real picture, not a blank canvas."""

import os

import numpy as np

from svgpvae_tpu_torch.utils.png import read_png


def pictures(run_dir) -> dict:
    """{name: (height, width, the PNG's text entries)} of every .png under
    run_dir/pics; each must decode and hold more than two colours."""
    pics = os.path.join(run_dir, "pics")
    out = {}
    for name in sorted(os.listdir(pics)):
        if not name.endswith(".png"):
            continue
        rgb, text = read_png(os.path.join(pics, name))
        assert len(np.unique(rgb.reshape(-1, 3), axis=0)) > 2, name
        out[name] = (rgb.shape[0], rgb.shape[1], text)
    return out
