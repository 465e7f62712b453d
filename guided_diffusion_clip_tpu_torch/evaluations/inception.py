"""The frozen FID InceptionV3 graph as a PyTorch module: the port of
``evaluations/inception_flax.py``.

The reference evaluator reads two tensors of the 2015
``classify_image_graph_def.pb`` TF1 graph: ``pool_3:0`` (2048-d pooled
features, for FID, IS and precision/recall) and the first 7 channels of
``mixed_6/conv:0`` (spatial features, for sFID). ``InceptionV3`` rebuilds
that network from the same architecture table, channels_last and float32:

  - every conv unit is conv + bias + ReLU (the converter folded the frozen
    BatchNorm into the conv's weight and bias); "SAME" at stride 1 pads
    symmetrically (the 1x7 and 7x1 kernels by (0, 3) and (3, 0)), the
    stride-2 stem and the reductions are "VALID";
  - max pools are 3/2 "VALID"; avg pools are 3/1 "SAME" and divide by the
    in-bounds count (``count_include_pad=False``); mixed_10's pool branch is
    MAX where mixed_9's is AVG, a quirk of this graph;
  - the graph's preprocessing: TF1's ``ResizeBilinear`` to 299 x 299
    (``legacy_resize_bilinear``: src = dst * in / out, no half-pixel
    centers, so not ``F.interpolate``), then (x - 128) / 128;
  - ``softmax(pool_3)`` is softmax(pool_3 @ softmax_w), no bias.

``forward`` runs its convs and its product with TF32 off (``full_f32``):
cuDNN's float32 convs take TF32 by default, whose 10-bit mantissas move the
features by ~1e-3.

Weights come as the JAX converter writes them (``name//w`` HWIO, ``name//b``,
``softmax_w``, ``spatial_pre_activation``): ``load_params`` reads that npz
with numpy and turns HWIO into OIHW; ``convert_pb`` writes it from the pb
(it needs TensorFlow, imported when called); ``random_params`` draws the
same arrays from a seed as the JAX module's.

    python -m guided_diffusion_clip_tpu_torch.evaluations.inception convert \\
        classify_image_graph_def.pb inception_v3_fid.npz
"""

from __future__ import annotations

import contextlib
import os
import sys

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# --------------------------------------------------------------------------
# architecture table (the JAX module's)
# --------------------------------------------------------------------------

# conv units: name -> (kh, kw, stride, padding, out_channels)
V = "VALID"
S = "SAME"

STEM = [
    ("conv", 3, 3, 2, V, 32),
    ("conv_1", 3, 3, 1, V, 32),
    ("conv_2", 3, 3, 1, S, 64),
    # maxpool 3x3/2 V
    ("conv_3", 1, 1, 1, V, 80),
    ("conv_4", 3, 3, 1, V, 192),
    # maxpool 3x3/2 V
]


def _inception_a(name: str, pool_proj: int):
    """35x35 block (mixed, mixed_1, mixed_2)."""
    return {
        "branch0": [(f"{name}/conv", 1, 1, 1, S, 64)],
        "branch5x5": [
            (f"{name}/tower/conv", 1, 1, 1, S, 48),
            (f"{name}/tower/conv_1", 5, 5, 1, S, 64),
        ],
        "branch3x3dbl": [
            (f"{name}/tower_1/conv", 1, 1, 1, S, 64),
            (f"{name}/tower_1/conv_1", 3, 3, 1, S, 96),
            (f"{name}/tower_1/conv_2", 3, 3, 1, S, 96),
        ],
        "branch_pool": [(f"{name}/tower_2/conv", 1, 1, 1, S, pool_proj)],
    }


def _inception_c(name: str, c7: int):
    """17x17 block (mixed_4..mixed_7)."""
    return {
        "branch0": [(f"{name}/conv", 1, 1, 1, S, 192)],
        "branch7x7": [
            (f"{name}/tower/conv", 1, 1, 1, S, c7),
            (f"{name}/tower/conv_1", 1, 7, 1, S, c7),
            (f"{name}/tower/conv_2", 7, 1, 1, S, 192),
        ],
        "branch7x7dbl": [
            (f"{name}/tower_1/conv", 1, 1, 1, S, c7),
            (f"{name}/tower_1/conv_1", 7, 1, 1, S, c7),
            (f"{name}/tower_1/conv_2", 1, 7, 1, S, c7),
            (f"{name}/tower_1/conv_3", 7, 1, 1, S, c7),
            (f"{name}/tower_1/conv_4", 1, 7, 1, S, 192),
        ],
        "branch_pool": [(f"{name}/tower_2/conv", 1, 1, 1, S, 192)],
    }


def _expected_conv_units():
    """name -> (kh, kw, stride, padding, out_ch) for every conv in the net."""
    units = {}

    def add(specs):
        for (n, kh, kw, s, p, c) in specs:
            units[n] = (kh, kw, s, p, c)

    add(STEM)
    for name, proj in (("mixed", 32), ("mixed_1", 64), ("mixed_2", 64)):
        for branch in _inception_a(name, proj).values():
            add(branch)
    # mixed_3 (reduction to 17x17)
    add([
        ("mixed_3/conv", 3, 3, 2, V, 384),
        ("mixed_3/tower/conv", 1, 1, 1, S, 64),
        ("mixed_3/tower/conv_1", 3, 3, 1, S, 96),
        ("mixed_3/tower/conv_2", 3, 3, 2, V, 96),
    ])
    for name, c7 in (("mixed_4", 128), ("mixed_5", 160), ("mixed_6", 160), ("mixed_7", 192)):
        for branch in _inception_c(name, c7).values():
            add(branch)
    # mixed_8 (reduction to 8x8)
    add([
        ("mixed_8/tower/conv", 1, 1, 1, S, 192),
        ("mixed_8/tower/conv_1", 3, 3, 2, V, 320),
        ("mixed_8/tower_1/conv", 1, 1, 1, S, 192),
        ("mixed_8/tower_1/conv_1", 1, 7, 1, S, 192),
        ("mixed_8/tower_1/conv_2", 7, 1, 1, S, 192),
        ("mixed_8/tower_1/conv_3", 3, 3, 2, V, 192),
    ])
    # mixed_9 / mixed_10 (8x8 blocks)
    for name in ("mixed_9", "mixed_10"):
        add([
            (f"{name}/conv", 1, 1, 1, S, 320),
            (f"{name}/tower/conv", 1, 1, 1, S, 384),
            (f"{name}/tower/mixed/conv", 1, 3, 1, S, 384),
            (f"{name}/tower/mixed/conv_1", 3, 1, 1, S, 384),
            (f"{name}/tower_1/conv", 1, 1, 1, S, 448),
            (f"{name}/tower_1/conv_1", 3, 3, 1, S, 384),
            (f"{name}/tower_1/mixed/conv", 1, 3, 1, S, 384),
            (f"{name}/tower_1/mixed/conv_1", 3, 1, 1, S, 384),
            (f"{name}/tower_2/conv", 1, 1, 1, S, 192),
        ])
    return units


def _trace_in_channels() -> dict:
    """Input channel count of every conv unit, from the concat structure."""
    units = _expected_conv_units()
    cin: dict = {}

    def chain(names, start):
        c = start
        for n in names:
            cin[n] = c
            c = units[n][4]
        return c

    c = 3
    c = chain(["conv", "conv_1", "conv_2"], c)
    c = chain(["conv_3", "conv_4"], c)
    for name, proj in (("mixed", 32), ("mixed_1", 64), ("mixed_2", 64)):
        outs = [
            chain([f"{name}/conv"], c),
            chain([f"{name}/tower/conv", f"{name}/tower/conv_1"], c),
            chain([f"{name}/tower_1/conv", f"{name}/tower_1/conv_1", f"{name}/tower_1/conv_2"], c),
            chain([f"{name}/tower_2/conv"], c),
        ]
        c = sum(outs)
    outs = [
        chain(["mixed_3/conv"], c),
        chain(["mixed_3/tower/conv", "mixed_3/tower/conv_1", "mixed_3/tower/conv_2"], c),
        c,  # max pool branch
    ]
    c = sum(outs)
    for name in ("mixed_4", "mixed_5", "mixed_6", "mixed_7"):
        outs = [
            chain([f"{name}/conv"], c),
            chain([f"{name}/tower/conv", f"{name}/tower/conv_1", f"{name}/tower/conv_2"], c),
            chain([f"{name}/tower_1/conv", f"{name}/tower_1/conv_1", f"{name}/tower_1/conv_2",
                   f"{name}/tower_1/conv_3", f"{name}/tower_1/conv_4"], c),
            chain([f"{name}/tower_2/conv"], c),
        ]
        c = sum(outs)
    outs = [
        chain(["mixed_8/tower/conv", "mixed_8/tower/conv_1"], c),
        chain(["mixed_8/tower_1/conv", "mixed_8/tower_1/conv_1",
               "mixed_8/tower_1/conv_2", "mixed_8/tower_1/conv_3"], c),
        c,  # max pool branch
    ]
    c = sum(outs)
    for name in ("mixed_9", "mixed_10"):
        b0 = chain([f"{name}/conv"], c)
        t = chain([f"{name}/tower/conv"], c)
        t_out = chain([f"{name}/tower/mixed/conv"], t) + chain([f"{name}/tower/mixed/conv_1"], t)
        t1 = chain([f"{name}/tower_1/conv"], c)
        t1 = chain([f"{name}/tower_1/conv_1"], t1)
        t1_out = chain([f"{name}/tower_1/mixed/conv"], t1) + chain([f"{name}/tower_1/mixed/conv_1"], t1)
        pool_out = chain([f"{name}/tower_2/conv"], c)
        c = b0 + t_out + t1_out + pool_out
    if c != 2048:
        raise AssertionError(f"trunk output channels {c} != 2048")
    return cin


# --------------------------------------------------------------------------
# forward pass
# --------------------------------------------------------------------------


def _axis_weights(in_size: int, out_size: int) -> tuple:
    """(lo, hi, frac) of one axis of TF1's resize: src = dst * in / out."""
    src = np.arange(out_size, dtype=np.float64) * (in_size / out_size)
    lo = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
    hi = np.minimum(lo + 1, in_size - 1)
    return lo, hi, (src - lo).astype(np.float32)


def legacy_resize_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """TF1 ``ResizeBilinear`` (align_corners=False, half_pixel_centers=False)
    of an NHWC batch, as index gathers; the input itself at its own size."""
    _, h, w, _ = x.shape
    if (h, w) == (out_h, out_w):
        return x
    ylo, yhi, yfrac = (torch.from_numpy(a).to(x.device) for a in _axis_weights(h, out_h))
    xlo, xhi, xfrac = (torch.from_numpy(a).to(x.device) for a in _axis_weights(w, out_w))
    yfrac = yfrac[None, :, None, None]
    xfrac = xfrac[None, None, :, None]
    rows = x[:, ylo] * (1.0 - yfrac) + x[:, yhi] * yfrac
    return rows[:, :, xlo] * (1.0 - xfrac) + rows[:, :, xhi] * xfrac


@contextlib.contextmanager
def full_f32():
    """float32 convs and products without TF32 for the block, restored after."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul


class InceptionV3(nn.Module):
    """``forward(x)`` of an NHWC float batch in [0, 255] at any size returns
    (pool_3 (B, 2048), spatial (B, 17, 17, 7)); ``softmax(pool_3)`` the IS
    predictions (B, 1008). With ``spatial_pre_activation`` the spatial
    features are the raw conv of ``mixed_6/conv_raw`` (the unfolded kernel,
    no bias, no ReLU), as the converter records for a pb whose
    ``mixed_6/conv:0`` is the Conv2D's output."""

    def __init__(self, spatial_pre_activation: bool = False):
        super().__init__()
        self.units = _expected_conv_units()
        cin = _trace_in_channels()
        self.convs = nn.ModuleDict()
        for name, (kh, kw, stride, padding, out_ch) in self.units.items():
            pad = (kh // 2, kw // 2) if padding == S else 0
            self.convs[name] = nn.Conv2d(cin[name], out_ch, (kh, kw), stride, pad)
        self.spatial_pre_activation = spatial_pre_activation
        if spatial_pre_activation:
            self.conv_raw = nn.Conv2d(cin["mixed_6/conv"], self.units["mixed_6/conv"][4], 1, bias=False)
        self.softmax_w = nn.Parameter(torch.zeros(2048, 1008))

    def conv(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.convs[name](x))

    def chain(self, names, x):
        for n in names:
            x = self.conv(n, x)
        return x

    def forward(self, x_0_255: torch.Tensor) -> tuple:
        with full_f32():
            return self.features(x_0_255)

    def features(self, x_0_255: torch.Tensor) -> tuple:
        """``forward`` under the caller's precision settings."""
        x = legacy_resize_bilinear(x_0_255.float(), 299, 299)
        x = ((x - 128.0) / 128.0).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)

        x = self.chain(["conv", "conv_1", "conv_2"], x)
        x = F.max_pool2d(x, 3, 2)
        x = self.chain(["conv_3", "conv_4"], x)
        x = F.max_pool2d(x, 3, 2)

        # 35x35
        for name in ("mixed", "mixed_1", "mixed_2"):
            x = torch.cat([
                self.conv(f"{name}/conv", x),
                self.chain([f"{name}/tower/conv", f"{name}/tower/conv_1"], x),
                self.chain([f"{name}/tower_1/conv", f"{name}/tower_1/conv_1", f"{name}/tower_1/conv_2"], x),
                self.conv(f"{name}/tower_2/conv", _avg_pool(x)),
            ], dim=1)

        # reduction to 17x17
        x = torch.cat([
            self.conv("mixed_3/conv", x),
            self.chain(["mixed_3/tower/conv", "mixed_3/tower/conv_1", "mixed_3/tower/conv_2"], x),
            F.max_pool2d(x, 3, 2),
        ], dim=1)

        # 17x17
        spatial = None
        for name in ("mixed_4", "mixed_5", "mixed_6", "mixed_7"):
            branch0 = self.conv(f"{name}/conv", x)
            if name == "mixed_6":
                spatial = self.conv_raw(x) if self.spatial_pre_activation else branch0
                spatial = spatial[:, :7].permute(0, 2, 3, 1)
            x = torch.cat([
                branch0,
                self.chain([f"{name}/tower/conv", f"{name}/tower/conv_1", f"{name}/tower/conv_2"], x),
                self.chain([f"{name}/tower_1/conv", f"{name}/tower_1/conv_1", f"{name}/tower_1/conv_2",
                            f"{name}/tower_1/conv_3", f"{name}/tower_1/conv_4"], x),
                self.conv(f"{name}/tower_2/conv", _avg_pool(x)),
            ], dim=1)

        # reduction to 8x8
        x = torch.cat([
            self.chain(["mixed_8/tower/conv", "mixed_8/tower/conv_1"], x),
            self.chain(["mixed_8/tower_1/conv", "mixed_8/tower_1/conv_1",
                        "mixed_8/tower_1/conv_2", "mixed_8/tower_1/conv_3"], x),
            F.max_pool2d(x, 3, 2),
        ], dim=1)

        # 8x8 (mixed_9: avg pool branch; mixed_10: MAX pool branch, the graph's quirk)
        for name, pool in (("mixed_9", _avg_pool), ("mixed_10", _max_pool_same)):
            t = self.conv(f"{name}/tower/conv", x)
            t1 = self.chain([f"{name}/tower_1/conv", f"{name}/tower_1/conv_1"], x)
            x = torch.cat([
                self.conv(f"{name}/conv", x),
                self.conv(f"{name}/tower/mixed/conv", t),
                self.conv(f"{name}/tower/mixed/conv_1", t),
                self.conv(f"{name}/tower_1/mixed/conv", t1),
                self.conv(f"{name}/tower_1/mixed/conv_1", t1),
                self.conv(f"{name}/tower_2/conv", pool(x)),
            ], dim=1)

        return x.mean(dim=(2, 3)), spatial.contiguous()

    def softmax(self, pool3: torch.Tensor) -> torch.Tensor:
        """IS predictions: softmax(pool_3 @ W), no bias."""
        with full_f32():
            return torch.softmax(pool3 @ self.softmax_w, dim=-1)


def _avg_pool(x):
    """TF AvgPool 3/1 SAME: divide by the count of in-bounds elements."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


def _max_pool_same(x):
    return F.max_pool2d(x, 3, 1, 1)


# --------------------------------------------------------------------------
# weights
# --------------------------------------------------------------------------


def random_params(seed: int = 0) -> dict:
    """Architecture-shaped random params in the JAX module's layout ({name:
    {"w": HWIO, "b"}}, "softmax_w"): the JAX ``random_params``' draws, in its
    order, so both packages build the same arrays from a seed."""
    rs = np.random.RandomState(seed)
    units = _expected_conv_units()
    params: dict = {}
    chans = _trace_in_channels()
    for name, (kh, kw, s, p, out_ch) in units.items():
        cin = chans[name]
        params[name] = {
            "w": (rs.standard_normal((kh, kw, cin, out_ch)) * (1.0 / np.sqrt(kh * kw * cin))).astype(np.float32),
            "b": np.zeros(out_ch, np.float32),
        }
    params["softmax_w"] = (rs.standard_normal((2048, 1008)) * 0.02).astype(np.float32)
    return params


def flat_params(params: dict) -> dict:
    """``params`` in the converter's flat npz layout: ``name//w``,
    ``name//b``, and the other entries as they are."""
    flat = {}
    for k, v in params.items():
        if isinstance(v, dict):
            flat[f"{k}//w"], flat[f"{k}//b"] = v["w"], v["b"]
        else:
            flat[k] = v
    return flat


def state_dict_from_params(params: dict) -> tuple:
    """(``InceptionV3``'s state_dict, spatial_pre_activation) of params in
    the JAX layout: conv kernels HWIO -> OIHW."""
    params = dict(params)
    flag = bool(params.pop("spatial_pre_activation", False))
    units = _expected_conv_units()
    sd = {}
    for name in units:
        p = params[name]
        sd[f"convs.{name}.weight"] = torch.from_numpy(np.asarray(p["w"], np.float32)).permute(3, 2, 0, 1)
        sd[f"convs.{name}.bias"] = torch.from_numpy(np.asarray(p["b"], np.float32))
    if flag:
        raw = params.get("mixed_6/conv_raw")
        if raw is None:
            raise ValueError("spatial_pre_activation=True needs the unfolded 'mixed_6/conv_raw' weights in the "
                             "params npz; re-run the pb->npz converter")
        sd["conv_raw.weight"] = torch.from_numpy(np.asarray(raw["w"], np.float32)).permute(3, 2, 0, 1)
    sd["softmax_w"] = torch.from_numpy(np.asarray(params["softmax_w"], np.float32))
    return {k: v.contiguous() for k, v in sd.items()}, flag


def load_params(npz_path: str) -> tuple:
    """(state_dict, spatial_pre_activation) from the converter's npz."""
    params: dict = {}
    with np.load(npz_path) as obj:
        for k in obj.files:
            if "//" in k:
                prefix, leaf = k.split("//")
                params.setdefault(prefix, {})[leaf] = obj[k]
            else:
                params[k] = obj[k]
    return state_dict_from_params(params)


def build_inception(weights, device="cpu") -> InceptionV3:
    """An eval-mode ``InceptionV3`` on ``device`` from the converter's npz
    path, or from params in the JAX layout."""
    sd, flag = load_params(weights) if isinstance(weights, (str, os.PathLike)) else state_dict_from_params(weights)
    model = InceptionV3(spatial_pre_activation=flag)
    model.load_state_dict(sd, strict=True)
    return model.to(device, memory_format=torch.channels_last).eval().requires_grad_(False)


# --------------------------------------------------------------------------
# converter: frozen .pb -> folded params npz (the JAX module's, for the port)
# --------------------------------------------------------------------------


def convert_pb(pb_path: str, out_path: str) -> dict:
    """One-time conversion of classify_image_graph_def.pb to a params npz.

    Walks the GraphDef structurally: for each BatchNorm-type node, its inputs
    are (conv_out, mean, variance, beta, gamma); the conv's weight const and
    the BN stats are folded into (w', b') with
        s = gamma / sqrt(var + eps);  w' = w * s;  b' = beta - mean * s.
    Keyed by the conv's TF scope prefix, so that a mismatch with the
    architecture table fails loudly. Needs TensorFlow.
    """
    import tensorflow.compat.v1 as tf

    with open(pb_path, "rb") as f:
        gd = tf.GraphDef()
        gd.ParseFromString(f.read())

    nodes = {n.name: n for n in gd.node}

    def const_value(name):
        node = nodes[name.split(":")[0]]
        if node.op != "Const":
            raise ValueError(f"{name}: expected Const, got {node.op}")
        return tf.make_ndarray(node.attr["value"].tensor)

    expected = _expected_conv_units()
    params: dict = {}
    unfolded_mixed6_w = None
    bn_ops = ("BatchNormWithGlobalNormalization", "FusedBatchNorm", "FusedBatchNormV3")
    for n in gd.node:
        if n.op not in bn_ops:
            continue
        conv_name = n.input[0].split(":")[0]
        conv = nodes[conv_name]
        if conv.op == "CheckNumerics":
            conv_name = conv.input[0].split(":")[0]
            conv = nodes[conv_name]
        if conv.op != "Conv2D":
            raise ValueError(f"{n.name}: BN input is {conv.op}, not Conv2D")
        w = const_value(conv.input[1])  # HWIO already (TF layout)
        if n.op == "BatchNormWithGlobalNormalization":
            mean, var, beta, gamma = (const_value(i) for i in n.input[1:5])
            eps = n.attr["variance_epsilon"].f
            if not n.attr["scale_after_normalization"].b:
                gamma = np.ones_like(mean)
        else:  # FusedBatchNorm input order: x, gamma, beta, mean, var
            gamma, beta, mean, var = (const_value(i) for i in n.input[1:5])
            eps = n.attr["epsilon"].f
        s = gamma / np.sqrt(var + eps)
        prefix = conv_name.rsplit("/", 1)[0] if "/" in conv_name else conv_name
        spec = expected.get(prefix)
        if spec is None:
            print(f"WARNING: unexpected conv scope {prefix!r} (shape {w.shape}) — skipped")
            continue
        kh, kw, _, _, out_ch = spec
        if w.shape[:2] != (kh, kw) or w.shape[3] != out_ch:
            raise ValueError(f"{prefix}: pb weight {w.shape} != expected ({kh},{kw},?,{out_ch})")
        params[prefix] = {
            "w": (w * s[None, None, None, :]).astype(np.float32),
            "b": (beta - mean * s).astype(np.float32),
        }
        if prefix == "mixed_6/conv":
            # the pre-fold kernel, for a pb whose mixed_6/conv:0 is the raw Conv2D output
            unfolded_mixed6_w = w.astype(np.float32)

    missing = sorted(set(expected) - set(params))
    if missing:
        raise ValueError(f"pb conversion missing conv units: {missing}")

    # IS softmax weight (no bias, as the reference's softmax graph)
    for n in gd.node:
        if n.name == "softmax/logits/MatMul":
            params["softmax_w"] = const_value(n.input[1]).astype(np.float32)
    if "softmax_w" not in params:
        raise ValueError("softmax/logits/MatMul weight not found in pb")

    # whether the tensor named mixed_6/conv:0 is the raw Conv2D output or the post-BN/ReLU one
    sp_node = nodes.get("mixed_6/conv")
    pre_act = sp_node is not None and sp_node.op == "Conv2D"
    params["spatial_pre_activation"] = np.asarray(pre_act)
    if pre_act:
        params["mixed_6/conv_raw"] = {
            "w": unfolded_mixed6_w,
            "b": np.zeros(unfolded_mixed6_w.shape[-1], np.float32),
        }
    np.savez(out_path, **flat_params(params))
    print(f"wrote {out_path} ({len(params) - 2} conv units)")
    return params


DEFAULT_WEIGHTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "inception_v3_fid.npz")


def find_converted_weights() -> str | None:
    cand = os.environ.get("INCEPTION_FLAX_NPZ", DEFAULT_WEIGHTS)
    return cand if os.path.exists(cand) else None


if __name__ == "__main__":
    if len(sys.argv) >= 3 and sys.argv[1] == "convert":
        convert_pb(sys.argv[2], sys.argv[3] if len(sys.argv) > 3 else DEFAULT_WEIGHTS)
    else:
        print(__doc__)
