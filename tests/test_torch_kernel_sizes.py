"""Sizes the port's kernels ask of the card, computed on the host: K3's
workspace grows with B * N (no adjacency is stored), and K1's launch
geometry fits a Hopper block's shared memory at the cascade's window
sizes."""

import pytest

from rapidobjectdetectionusingcascadedcnns_torch.ops import nms_cuda, windows_cuda


def test_k3_workspace_is_linear_in_rows():
    """At the dense path's open rung (4 frames x 131,903 rows) the
    workspace stays under 64 MB, and doubling N doubles it."""
    at_open_rung = nms_cuda.workspace_bytes(4, 131903)
    assert at_open_rung < 64 * 2**20
    assert nms_cuda.workspace_bytes(4, 2 * 131903) - 4 == 2 * (at_open_rung - 4)
    assert nms_cuda.workspace_bytes(8, 131903) - 4 == 2 * (at_open_rung - 4)


def test_k1_launch_geometry_fits_shared_memory():
    """Boxes per block and the shared memory they take (output tile,
    bf16 intermediate, taps) at 12, 24 and 48 px with 3 channels: within
    the 227 KB a block may have, and each box's output a multiple of 16
    bytes (the bulk store's unit). A window too large to stage raises."""
    for size, per_block in ((12, 5), (24, 2), (48, 1)):
        got_per_block, smem = windows_cuda.launch_geometry(size, size, 3)
        assert got_per_block == per_block
        assert smem == per_block * (8 * size * size * 3 + 40 * size)
        assert smem <= 227 * 1024
        assert (size * size * 3 * 4) % 16 == 0
    with pytest.raises(ValueError):
        windows_cuda.launch_geometry(128, 128, 3)
