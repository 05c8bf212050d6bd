"""The one traffic generator: a traffic file's parameters and a seed ->
the pool of requests a run sends, closed loop, in a fixed order.

A traffic file (``benchmark/traffic/<name>.json``) gives:

  * ``frame``: ``height``, ``width``, ``n_faces``, ``min_face``,
    ``max_face`` of the synthetic scenes;
  * ``encoding``: ``"yuv420"`` (Y and UV planes) or ``"rgb"``;
  * ``frames_per_request`` and ``pool_frames``: the pool is
    ``pool_frames`` distinct scenes, cut into requests of
    ``frames_per_request`` frames that the client sends in turn, over and
    over, one at a time (one client, back to back);
  * ``entry``: the detector call a request goes through;
  * ``detector``: settings the traffic runs the detector with (the
    FDDB application's scale factor, say);
  * ``calibration``: the survivors a frame keeps after each stage, by
    which each stage's threshold is set (``harness/calibrate.py``).

Every seed gives the same sizes and the same number of requests; only the
pixels differ.
"""

from __future__ import annotations

from typing import List

import numpy as np

from . import scenes


def scene_seeds(seed: int, n: int) -> List[int]:
    """``n`` scene seeds below 2**32 drawn from a run seed of any size."""
    return [int(s) for s in np.random.SeedSequence(int(seed)).generate_state(n)]


class Pool:
    """The frames of a run and the requests they are cut into."""

    def __init__(self, traffic: dict, seed: int):
        fr = traffic["frame"]
        self.traffic = traffic
        self.encoding = traffic["encoding"]
        self.per_request = int(traffic["frames_per_request"])
        n = int(traffic["pool_frames"])
        if n % self.per_request:
            raise ValueError("pool_frames must be a multiple of frames_per_request")
        self.rgb = [scenes.make_scene(fr["height"], fr["width"], fr["n_faces"], s,
                                      fr["min_face"], fr["max_face"])
                    for s in scene_seeds(seed, n)]
        if self.encoding == "yuv420":
            self.payload = [scenes.rgb_to_yuv420(im) for im in self.rgb]
        elif self.encoding == "rgb":
            self.payload = self.rgb
        else:
            raise ValueError("unknown encoding {!r}".format(self.encoding))

    @property
    def n_frames(self) -> int:
        return len(self.rgb)

    @property
    def n_requests(self) -> int:
        return self.n_frames // self.per_request

    def request(self, k: int):
        """(frame indices, payload) of the k-th request sent."""
        r = k % self.n_requests
        idx = list(range(r * self.per_request, (r + 1) * self.per_request))
        return idx, [self.payload[i] for i in idx]

    def frames_tensor(self, idx, device):
        """The RGB frames ``idx`` as the reference reads them: (B, H, W, 3)
        float32 decoded the way the request carried them."""
        import torch

        from ..reference import cnn as ref_cnn

        if self.encoding == "yuv420":
            y = torch.as_tensor(np.stack([self.payload[i][0] for i in idx]), device=device)
            uv = torch.as_tensor(np.stack([self.payload[i][1] for i in idx]), device=device)
            return ref_cnn.yuv420_to_rgb(y, uv)
        return torch.as_tensor(np.stack([self.rgb[i] for i in idx]), device=device).float()
