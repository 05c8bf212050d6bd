"""The full InceptionV3 trunk and the conversion of torchvision weights
(counterpart of models/inception_v3.py of the JAX package).

The reference's ``append_inception`` grafts the pretrained Inception-2015
graph and taps its 2048-wide ``pool_3`` bottleneck
(network/inception_builder.py:28-96). Nothing is downloaded here: a user
who has InceptionV3 weights in the torchvision state-dict layout converts
them (:func:`convert_torchvision_state_dict`, ``tools/convert_torch_inception.py``)
into the ``v3/`` archive that both packages load, and the cascade's
appended stage runs :func:`apply_v3` on them: the stem (Conv2d_1a..4a),
Mixed_5b..7c and the global mean, 299x299 -> 2048.

Layouts: the archive and the JAX package hold each folded conv in HWIO;
the port's trunk holds it in OIHW, the layout ``F.conv2d`` takes, so a
weight is transposed once where it enters the port
(``models/inception.py::backbone_from_numpy``) and once where it leaves
(``backbone_to_flat``). The convolutions go to cuDNN through ``F.conv2d``:
the JAX package leaves them to XLA, they are not Pallas kernels.

Rounding points, as the JAX ``apply_v3``: each conv takes operands in the
compute dtype and accumulates in f32; the bias add and the relu run in f32
and the result is cast to the compute dtype. (``F.conv2d`` returns its f32
accumulator rounded to the compute dtype before the f32 bias add, where
XLA hands the accumulator on: in bf16 one more rounding, within the bf16
tolerance of the tests; in f32 none.) Max pools are 3/2 VALID; the 3x3
average pool counts its zero padding, sums in f32, rounds the sum to the
compute dtype and divides there (XLA accumulates a bf16 window sum in f32
and rounds it, then divides in bf16); the final mean runs in f32.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

BOTTLENECK_TENSOR_SIZE = 2048
BN_EPS = 1e-3  # torchvision BatchNorm2d(eps=0.001)

Params = Dict[str, Dict[str, object]]

# conv channel table: torchvision module path -> (cin, cout, (kh, kw))
# (architecture constants of InceptionV3; stride/padding live in the forward)
V3_CONVS: Dict[str, tuple] = {
    "Conv2d_1a_3x3": (3, 32, (3, 3)),
    "Conv2d_2a_3x3": (32, 32, (3, 3)),
    "Conv2d_2b_3x3": (32, 64, (3, 3)),
    "Conv2d_3b_1x1": (64, 80, (1, 1)),
    "Conv2d_4a_3x3": (80, 192, (3, 3)),
}


def _inception_a(prefix: str, cin: int, pool_features: int) -> Dict[str, tuple]:
    return {
        f"{prefix}.branch1x1": (cin, 64, (1, 1)),
        f"{prefix}.branch5x5_1": (cin, 48, (1, 1)),
        f"{prefix}.branch5x5_2": (48, 64, (5, 5)),
        f"{prefix}.branch3x3dbl_1": (cin, 64, (1, 1)),
        f"{prefix}.branch3x3dbl_2": (64, 96, (3, 3)),
        f"{prefix}.branch3x3dbl_3": (96, 96, (3, 3)),
        f"{prefix}.branch_pool": (cin, pool_features, (1, 1)),
    }


def _inception_b(prefix: str, cin: int) -> Dict[str, tuple]:
    return {
        f"{prefix}.branch3x3": (cin, 384, (3, 3)),
        f"{prefix}.branch3x3dbl_1": (cin, 64, (1, 1)),
        f"{prefix}.branch3x3dbl_2": (64, 96, (3, 3)),
        f"{prefix}.branch3x3dbl_3": (96, 96, (3, 3)),
    }


def _inception_c(prefix: str, cin: int, c7: int) -> Dict[str, tuple]:
    return {
        f"{prefix}.branch1x1": (cin, 192, (1, 1)),
        f"{prefix}.branch7x7_1": (cin, c7, (1, 1)),
        f"{prefix}.branch7x7_2": (c7, c7, (1, 7)),
        f"{prefix}.branch7x7_3": (c7, 192, (7, 1)),
        f"{prefix}.branch7x7dbl_1": (cin, c7, (1, 1)),
        f"{prefix}.branch7x7dbl_2": (c7, c7, (7, 1)),
        f"{prefix}.branch7x7dbl_3": (c7, c7, (1, 7)),
        f"{prefix}.branch7x7dbl_4": (c7, c7, (7, 1)),
        f"{prefix}.branch7x7dbl_5": (c7, 192, (1, 7)),
        f"{prefix}.branch_pool": (cin, 192, (1, 1)),
    }


def _inception_d(prefix: str, cin: int) -> Dict[str, tuple]:
    return {
        f"{prefix}.branch3x3_1": (cin, 192, (1, 1)),
        f"{prefix}.branch3x3_2": (192, 320, (3, 3)),
        f"{prefix}.branch7x7x3_1": (cin, 192, (1, 1)),
        f"{prefix}.branch7x7x3_2": (192, 192, (1, 7)),
        f"{prefix}.branch7x7x3_3": (192, 192, (7, 1)),
        f"{prefix}.branch7x7x3_4": (192, 192, (3, 3)),
    }


def _inception_e(prefix: str, cin: int) -> Dict[str, tuple]:
    return {
        f"{prefix}.branch1x1": (cin, 320, (1, 1)),
        f"{prefix}.branch3x3_1": (cin, 384, (1, 1)),
        f"{prefix}.branch3x3_2a": (384, 384, (1, 3)),
        f"{prefix}.branch3x3_2b": (384, 384, (3, 1)),
        f"{prefix}.branch3x3dbl_1": (cin, 448, (1, 1)),
        f"{prefix}.branch3x3dbl_2": (448, 384, (3, 3)),
        f"{prefix}.branch3x3dbl_3a": (384, 384, (1, 3)),
        f"{prefix}.branch3x3dbl_3b": (384, 384, (3, 1)),
        f"{prefix}.branch_pool": (cin, 192, (1, 1)),
    }


def conv_table() -> Dict[str, tuple]:
    """Every trunk conv of torchvision InceptionV3: path -> (cin, cout, k)."""
    table = dict(V3_CONVS)
    table.update(_inception_a("Mixed_5b", 192, 32))
    table.update(_inception_a("Mixed_5c", 256, 64))
    table.update(_inception_a("Mixed_5d", 288, 64))
    table.update(_inception_b("Mixed_6a", 288))
    table.update(_inception_c("Mixed_6b", 768, 128))
    table.update(_inception_c("Mixed_6c", 768, 160))
    table.update(_inception_c("Mixed_6d", 768, 160))
    table.update(_inception_c("Mixed_6e", 768, 192))
    table.update(_inception_d("Mixed_7a", 768))
    table.update(_inception_e("Mixed_7b", 1280))
    table.update(_inception_e("Mixed_7c", 2048))
    return table


# --------------------------------------------------------------------------
# conversion (torchvision state dict -> folded HWIO archive tree, numpy)
# --------------------------------------------------------------------------


def convert_torchvision_state_dict(state_dict: Dict[str, object]) -> Dict[str, dict]:
    """Fold each BasicConv2d (conv bias=False + BN eps=1e-3 + relu) into a
    single conv with bias, transposing OIHW -> HWIO (the archive's layout).

    ``state_dict``: a torchvision ``inception_v3`` state dict of numpy
    arrays or torch tensors. ``fc.*`` / ``AuxLogits.*`` entries are ignored
    (the cascade supplies its own fc2 head). A missing trunk weight raises
    ``KeyError``, a weight of another shape or a module the trunk does not
    have ``ValueError``. Returns numpy float32 arrays, bit-equal to the JAX
    package's conversion."""

    def arr(name):
        v = state_dict[name]
        return v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)

    params: Dict[str, dict] = {}
    for path, (cin, cout, (kh, kw)) in conv_table().items():
        w = arr(path + ".conv.weight")  # (cout, cin, kh, kw)
        if w.shape != (cout, cin, kh, kw):
            raise ValueError(
                "unexpected shape for {}: {} (want {})".format(
                    path, w.shape, (cout, cin, kh, kw)
                )
            )
        gamma = arr(path + ".bn.weight")
        beta = arr(path + ".bn.bias")
        mean = arr(path + ".bn.running_mean")
        var = arr(path + ".bn.running_var")
        scale = gamma / np.sqrt(var + BN_EPS)
        w_folded = np.transpose(w, (2, 3, 1, 0)) * scale[None, None, None, :]
        b_folded = beta - mean * scale
        params[path] = {
            "W": w_folded.astype(np.float32),
            "b": b_folded.astype(np.float32),
        }

    extra = {
        k.split(".")[0]
        for k in state_dict
        if k.split(".")[0] not in {p.split(".")[0] for p in params}
        and k.split(".")[0] not in {"fc", "AuxLogits", "dropout", "avgpool"}
    }
    if extra:
        raise ValueError("unrecognized state-dict modules: {}".format(sorted(extra)))
    return params


def random_state_dict(seed: int = 0) -> Dict[str, np.ndarray]:
    """A random torchvision-layout state dict, the same numpy draw as the
    JAX package's (so the same arrays for the same seed): the fixture that
    stands in for pretrained weights, which are never downloaded."""
    rs = np.random.RandomState(seed)
    sd: Dict[str, np.ndarray] = {}
    for path, (cin, cout, (kh, kw)) in conv_table().items():
        sd[path + ".conv.weight"] = rs.randn(cout, cin, kh, kw).astype(np.float32) * 0.05
        sd[path + ".bn.weight"] = rs.rand(cout).astype(np.float32) + 0.5
        sd[path + ".bn.bias"] = rs.randn(cout).astype(np.float32) * 0.1
        sd[path + ".bn.running_mean"] = rs.randn(cout).astype(np.float32) * 0.1
        sd[path + ".bn.running_var"] = rs.rand(cout).astype(np.float32) + 0.5
    return sd


# --------------------------------------------------------------------------
# the archive ("v3/" namespace, the cf["inception_weights_path"] format)
# --------------------------------------------------------------------------


def save_npz(path: str, params: Dict[str, dict]) -> None:
    """Write a converted (HWIO, numpy) tree as the ``v3/`` archive."""
    flat = {}
    for conv_path, p in params.items():
        flat["v3/{}/W".format(conv_path)] = np.asarray(p["W"])
        flat["v3/{}/b".format(conv_path)] = np.asarray(p["b"])
    np.savez(path, **flat)


def params_from_flat(flat: Dict[str, np.ndarray]) -> Dict[str, dict]:
    """The archive's leaves -> the converted (HWIO) tree; raises
    ``KeyError`` on a leaf outside ``v3/`` or a missing conv."""
    params: Dict[str, dict] = {}
    for key, value in flat.items():
        if not key.startswith("v3/"):
            raise KeyError("not a v3 backbone archive: {}".format(key))
        _, conv_path, leaf = key.split("/")
        params.setdefault(conv_path, {})[leaf] = value
    missing = set(conv_table()) - set(params)
    if missing:
        raise KeyError("v3 archive missing convs: {}".format(sorted(missing)[:5]))
    return params


def n_params(params: Dict[str, dict]) -> int:
    return sum(int(np.asarray(p["W"]).size) + int(np.asarray(p["b"]).size)
               for p in params.values())


# --------------------------------------------------------------------------
# forward (NCHW inside; OIHW weights)
# --------------------------------------------------------------------------


def _conv(params, path, x, stride=1, padding=(0, 0), dtype=torch.bfloat16):
    p = params[path]
    out = F.conv2d(x.to(dtype), p["W"].to(dtype), stride=stride, padding=padding)
    return torch.relu(out.float() + p["b"].float()[:, None, None]).to(dtype)


def _max_pool(x):
    return F.max_pool2d(x, 3, 2)


def _avg_pool_3_1_1(x):
    """AvgPool2d(3, stride=1, padding=1) with count_include_pad=True."""
    summed = F.avg_pool2d(x.float(), 3, stride=1, padding=1, divisor_override=1)
    return summed.to(x.dtype) / 9


def _block_a(params, prefix, x, dtype):
    b1 = _conv(params, f"{prefix}.branch1x1", x, dtype=dtype)
    b5 = _conv(params, f"{prefix}.branch5x5_1", x, dtype=dtype)
    b5 = _conv(params, f"{prefix}.branch5x5_2", b5, padding=(2, 2), dtype=dtype)
    b3 = _conv(params, f"{prefix}.branch3x3dbl_1", x, dtype=dtype)
    b3 = _conv(params, f"{prefix}.branch3x3dbl_2", b3, padding=(1, 1), dtype=dtype)
    b3 = _conv(params, f"{prefix}.branch3x3dbl_3", b3, padding=(1, 1), dtype=dtype)
    bp = _conv(params, f"{prefix}.branch_pool", _avg_pool_3_1_1(x), dtype=dtype)
    return torch.cat([b1, b5, b3, bp], dim=1)


def _block_b(params, prefix, x, dtype):
    b3 = _conv(params, f"{prefix}.branch3x3", x, stride=2, dtype=dtype)
    bd = _conv(params, f"{prefix}.branch3x3dbl_1", x, dtype=dtype)
    bd = _conv(params, f"{prefix}.branch3x3dbl_2", bd, padding=(1, 1), dtype=dtype)
    bd = _conv(params, f"{prefix}.branch3x3dbl_3", bd, stride=2, dtype=dtype)
    return torch.cat([b3, bd, _max_pool(x)], dim=1)


def _block_c(params, prefix, x, dtype):
    b1 = _conv(params, f"{prefix}.branch1x1", x, dtype=dtype)
    b7 = _conv(params, f"{prefix}.branch7x7_1", x, dtype=dtype)
    b7 = _conv(params, f"{prefix}.branch7x7_2", b7, padding=(0, 3), dtype=dtype)
    b7 = _conv(params, f"{prefix}.branch7x7_3", b7, padding=(3, 0), dtype=dtype)
    bd = _conv(params, f"{prefix}.branch7x7dbl_1", x, dtype=dtype)
    bd = _conv(params, f"{prefix}.branch7x7dbl_2", bd, padding=(3, 0), dtype=dtype)
    bd = _conv(params, f"{prefix}.branch7x7dbl_3", bd, padding=(0, 3), dtype=dtype)
    bd = _conv(params, f"{prefix}.branch7x7dbl_4", bd, padding=(3, 0), dtype=dtype)
    bd = _conv(params, f"{prefix}.branch7x7dbl_5", bd, padding=(0, 3), dtype=dtype)
    bp = _conv(params, f"{prefix}.branch_pool", _avg_pool_3_1_1(x), dtype=dtype)
    return torch.cat([b1, b7, bd, bp], dim=1)


def _block_d(params, prefix, x, dtype):
    b3 = _conv(params, f"{prefix}.branch3x3_1", x, dtype=dtype)
    b3 = _conv(params, f"{prefix}.branch3x3_2", b3, stride=2, dtype=dtype)
    b7 = _conv(params, f"{prefix}.branch7x7x3_1", x, dtype=dtype)
    b7 = _conv(params, f"{prefix}.branch7x7x3_2", b7, padding=(0, 3), dtype=dtype)
    b7 = _conv(params, f"{prefix}.branch7x7x3_3", b7, padding=(3, 0), dtype=dtype)
    b7 = _conv(params, f"{prefix}.branch7x7x3_4", b7, stride=2, dtype=dtype)
    return torch.cat([b3, b7, _max_pool(x)], dim=1)


def _block_e(params, prefix, x, dtype):
    b1 = _conv(params, f"{prefix}.branch1x1", x, dtype=dtype)
    b3 = _conv(params, f"{prefix}.branch3x3_1", x, dtype=dtype)
    b3 = torch.cat(
        [
            _conv(params, f"{prefix}.branch3x3_2a", b3, padding=(0, 1), dtype=dtype),
            _conv(params, f"{prefix}.branch3x3_2b", b3, padding=(1, 0), dtype=dtype),
        ],
        dim=1,
    )
    bd = _conv(params, f"{prefix}.branch3x3dbl_1", x, dtype=dtype)
    bd = _conv(params, f"{prefix}.branch3x3dbl_2", bd, padding=(1, 1), dtype=dtype)
    bd = torch.cat(
        [
            _conv(params, f"{prefix}.branch3x3dbl_3a", bd, padding=(0, 1), dtype=dtype),
            _conv(params, f"{prefix}.branch3x3dbl_3b", bd, padding=(1, 0), dtype=dtype),
        ],
        dim=1,
    )
    bp = _conv(params, f"{prefix}.branch_pool", _avg_pool_3_1_1(x), dtype=dtype)
    return torch.cat([b1, b3, bd, bp], dim=1)


def apply_v3(params: Params, x: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """(N, 299, 299, 3) standardized input -> (N, 2048) float32 pool_3
    bottleneck; ``params``: the port's trunk (OIHW weights)."""
    h = x.to(dtype).permute(0, 3, 1, 2)
    h = _conv(params, "Conv2d_1a_3x3", h, stride=2, dtype=dtype)
    h = _conv(params, "Conv2d_2a_3x3", h, dtype=dtype)
    h = _conv(params, "Conv2d_2b_3x3", h, padding=(1, 1), dtype=dtype)
    h = _max_pool(h)
    h = _conv(params, "Conv2d_3b_1x1", h, dtype=dtype)
    h = _conv(params, "Conv2d_4a_3x3", h, dtype=dtype)
    h = _max_pool(h)
    for prefix in ("Mixed_5b", "Mixed_5c", "Mixed_5d"):
        h = _block_a(params, prefix, h, dtype)
    h = _block_b(params, "Mixed_6a", h, dtype)
    for prefix in ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
        h = _block_c(params, prefix, h, dtype)
    h = _block_d(params, "Mixed_7a", h, dtype)
    h = _block_e(params, "Mixed_7b", h, dtype)
    h = _block_e(params, "Mixed_7c", h, dtype)
    return h.float().mean(dim=(2, 3))  # adaptive avg pool -> 2048
