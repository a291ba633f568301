"""Plain float32 Depth-Anything-V2: a DINOv2 ViT encoder and the DPT head.

The forward follows the published model (Depth-Anything-V2 ``dpt.py`` and
DINOv2 ``vision_transformer.py``): patch embedding, cls token, the bicubic
pos-embed resampling with DINOv2's 0.1 offset, pre-norm blocks with
LayerScale, exact GELU, softmax attention, four normed taps, and the DPT
head (projections, the resize layers, the refinenets with their 2x bilinear
upsampling before the 1x1 ``out_conv``, ``output_conv1``, the resize to the
patch grid's pixels and ``output_conv2``). It is written from the model's
definition alone: no kernel, no cache, no batching trick. Weights are a
dict keyed by the published state-dict names (``param_specs``).

A configuration's model entry names this module as its ``reference`` and
states the sizes in ``READS``; the program's preset must agree with them,
and with ``REQUIRES`` on everything this forward does not read
(``harness.check_preset``). ``WEIGHT_KEYS`` are the benchmark's own draw.

``quant="fp8"`` computes the model as the program computes it in bf16, one
precision lower: every activation an operation produces (the residual
stream, norms, GELU, the attention's probabilities, each linear layer's and
convolution's inputs and outputs, resizes, sums) and every weight is
rounded to float8 e4m3, scaled per row (per pixel across channels for maps;
per output channel for weights), and the arithmetic between roundings stays
float32; the backward rounds each of those tensors' gradients alike. It is
the benchmark's control.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["READS", "REQUIRES", "IGNORES", "WEIGHT_KEYS", "OPTIONS", "param_specs", "depth_forward",
           "encoder_forward"]

PATCH = 14
LN_EPS = 1e-6

# the preset's attributes this forward reads from the model entry
READS = ("embed_dim", "depth", "num_heads", "mlp_ratio", "base_img_size", "out_indices",
         "interpolate_offset", "features", "out_channels", "trailing_head_relu",
         "interp_to_input")
# the preset's attributes this forward computes only at these values
REQUIRES = {"patch_size": PATCH, "ffn": "mlp", "num_register_tokens": 0, "window_size": None,
            "use_cls_token": True, "use_pos_conv": False, "final_taps": False,
            "tap_norm": True, "lora_rank": 0, "use_ssf": False, "head_out_channels": 1,
            "use_clstoken": False, "wo_relu_1_2_channel": False}
# attributes that do not change what the forward computes: names, the
# encoder object, LayerScale's init (a parameter the benchmark draws) and the
# PEG schedule (no PEG, by REQUIRES)
IGNORES = ("name", "arch_name", "encoder", "init_values", "pe_start_step", "pe_total_step")
# the model entry's keys of the benchmark's weight draw
WEIGHT_KEYS = ("layerscale_init",)
# the program's create_model options this forward computes only at these values
OPTIONS = {"quant": "none"}


def param_specs(m: dict) -> list[tuple[str, tuple, str, float]]:
    """``(name, shape, kind, value)`` of every parameter of the model ``m``
    (a configuration's model entry). ``kind`` is ``normal`` (``value`` is
    the standard deviation), ``abs_normal`` (its absolute value) or
    ``const`` (every element is ``value``)."""
    d, depth = m["embed_dim"], m["depth"]
    hidden = int(d * m["mlp_ratio"])
    base = m["base_img_size"] // PATCH
    f, oc = m["features"], m["out_channels"]
    specs = []

    def lin(name, n_out, n_in, k=1):  # the head's layers are convolutions, k x k
        shape = (n_out, n_in, k, k) if name.startswith("depth_head") else (n_out, n_in)
        specs.append((f"{name}.weight", shape, "normal", 1.0 / math.sqrt(n_in * k * k)))

    def bias(name, n):
        specs.append((f"{name}.bias", (n,), "const", 0.0))

    def norm(name, n):
        specs.append((f"{name}.weight", (n,), "const", 1.0))
        bias(name, n)

    p = "pretrained"
    specs.append((f"{p}.cls_token", (1, 1, d), "normal", 1e-6))
    specs.append((f"{p}.pos_embed", (1, base * base + 1, d), "normal", 0.02))
    specs.append((f"{p}.patch_embed.proj.weight", (d, 3, PATCH, PATCH), "normal", 0.02))
    bias(f"{p}.patch_embed.proj", d)
    for i in range(depth):
        b = f"{p}.blocks.{i}"
        norm(f"{b}.norm1", d)
        for name, n_out, n_in in (("attn.qkv", 3 * d, d), ("attn.proj", d, d)):
            lin(f"{b}.{name}", n_out, n_in)
            bias(f"{b}.{name}", n_out)
        specs.append((f"{b}.ls1.gamma", (d,), "const", m["layerscale_init"]))
        norm(f"{b}.norm2", d)
        for name, n_out, n_in in (("mlp.fc1", hidden, d), ("mlp.fc2", d, hidden)):
            lin(f"{b}.{name}", n_out, n_in)
            bias(f"{b}.{name}", n_out)
        specs.append((f"{b}.ls2.gamma", (d,), "const", m["layerscale_init"]))
    norm(f"{p}.norm", d)
    h = "depth_head"
    for i, c in enumerate(oc):
        lin(f"{h}.projects.{i}", c, d)
        bias(f"{h}.projects.{i}", c)
    for i, k in ((0, 4), (1, 2)):  # transposed convs: weight [in, out, k, k]
        specs.append((f"{h}.resize_layers.{i}.weight", (oc[i], oc[i], k, k), "normal",
                      1.0 / math.sqrt(3 * oc[i])))
        bias(f"{h}.resize_layers.{i}", oc[i])
    lin(f"{h}.resize_layers.3", oc[3], oc[3], 3)
    bias(f"{h}.resize_layers.3", oc[3])
    s = f"{h}.scratch"
    for i, c in enumerate(oc):
        lin(f"{s}.layer{i + 1}_rn", f, c, 3)
    for r in range(1, 5):
        units = ("resConfUnit1", "resConfUnit2") if r != 4 else ("resConfUnit2",)
        for u in units:
            for conv in ("conv1", "conv2"):
                lin(f"{s}.refinenet{r}.{u}.{conv}", f, f, 3)
                bias(f"{s}.refinenet{r}.{u}.{conv}", f)
        lin(f"{s}.refinenet{r}.out_conv", f, f)
        bias(f"{s}.refinenet{r}.out_conv", f)
    lin(f"{s}.output_conv1", f // 2, f, 3)
    bias(f"{s}.output_conv1", f // 2)
    lin(f"{s}.output_conv2.0", 32, f // 2, 3)
    bias(f"{s}.output_conv2.0", 32)
    # the last 1x1 conv reads ReLU'd features: non-negative weights keep the
    # depth positive and varied over the image, as a trained model's is (with
    # signed ones, a random head zeroes 30-99% of the pixels after its ReLU)
    specs.append((f"{s}.output_conv2.2.weight", (1, 32, 1, 1), "abs_normal",
                  1.0 / math.sqrt(32)))
    bias(f"{s}.output_conv2.2", 1)
    return specs


def _round(x: torch.Tensor, dim, quant: str) -> torch.Tensor:
    if quant != "fp8":
        raise ValueError(f"the reference rounds to fp8 alone, not {quant!r}")
    scale = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / 448.0  # e4m3's largest
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class _Rounded(torch.autograd.Function):
    """Rounded in the forward, and its gradient rounded alike in the
    backward: the step computed in the lower precision both ways."""

    @staticmethod
    def forward(ctx, x, dim, quant):
        ctx.dim, ctx.quant = dim, quant
        return _round(x, dim, quant)

    @staticmethod
    def backward(ctx, g):
        return _round(g, ctx.dim, ctx.quant), None, None


def _fake_quant(x: torch.Tensor, dim, quant: str) -> torch.Tensor:
    return _Rounded.apply(x, dim, quant)


def _q(x: torch.Tensor, quant, dim=-1) -> torch.Tensor:
    """An activation as the control stores it (itself without ``quant``)."""
    return _fake_quant(x, dim, quant) if quant else x


def _linear(x, w, b, quant):
    if quant:
        x, w = _fake_quant(x, -1, quant), _fake_quant(w, -1, quant)
    return _q(F.linear(x, w, b), quant)


def _conv(x, w, b, quant, **kw):
    if quant:
        x, w = _fake_quant(x, 1, quant), _fake_quant(w, (1, 2, 3), quant)
    return _q(F.conv2d(x, w, b, **kw), quant, 1)


def _layer_norm(x, W, name, quant=None):
    return _q(F.layer_norm(x, x.shape[-1:], W[f"{name}.weight"], W[f"{name}.bias"], LN_EPS),
              quant)


def _attention(x, W, name, heads, quant):
    b, n, c = x.shape
    qkv = _linear(x, W[f"{name}.qkv.weight"], W[f"{name}.qkv.bias"], quant)
    q, k, v = qkv.reshape(b, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    out = []
    for i in range(b):  # one image at a time: N^2 scores of a 1036^2 image are 1.4 GB
        s = (q[i] @ k[i].transpose(-1, -2)) * (c // heads) ** -0.5
        out.append(_q(torch.softmax(s, dim=-1), quant) @ v[i])
    o = torch.stack(out).transpose(1, 2).reshape(b, n, c)
    return _linear(o, W[f"{name}.proj.weight"], W[f"{name}.proj.bias"], quant)


def _pos_embed(W, m, gh, gw):
    pe = W["pretrained.pos_embed"]
    base = m["base_img_size"] // PATCH
    grid = pe[:, 1:].reshape(1, base, base, -1).permute(0, 3, 1, 2)
    off = m["interpolate_offset"]
    grid = F.interpolate(grid, scale_factor=((gh + off) / base, (gw + off) / base),
                         mode="bicubic", align_corners=False)
    if grid.shape[-2:] != (gh, gw):
        raise ValueError(f"pos-embed resampled to {tuple(grid.shape[-2:])}, not {(gh, gw)}")
    return torch.cat([pe[:, :1], grid.flatten(2).transpose(1, 2)], dim=1)


def encoder_forward(W: dict, m: dict, x: torch.Tensor, quant: str | None = None):
    """Four normed taps ``[B, N, C]`` (patch tokens) of ``x [B, 3, H, W]``."""
    b, _, h, w = x.shape
    gh, gw = h // PATCH, w // PATCH
    p = "pretrained"
    t = _conv(x, W[f"{p}.patch_embed.proj.weight"], W[f"{p}.patch_embed.proj.bias"], quant,
              stride=PATCH).flatten(2).transpose(1, 2)
    t = torch.cat([W[f"{p}.cls_token"].expand(b, -1, -1), t], dim=1)
    t = _q(t + _pos_embed(W, m, gh, gw), quant)
    taps = []
    for i in range(m["depth"]):
        blk = f"{p}.blocks.{i}"
        a = _attention(_layer_norm(t, W, f"{blk}.norm1", quant), W, f"{blk}.attn",
                       m["num_heads"], quant)
        t = _q(t + W[f"{blk}.ls1.gamma"] * a, quant)
        y = _linear(_layer_norm(t, W, f"{blk}.norm2", quant), W[f"{blk}.mlp.fc1.weight"],
                    W[f"{blk}.mlp.fc1.bias"], quant)
        y = _linear(_q(F.gelu(y), quant), W[f"{blk}.mlp.fc2.weight"], W[f"{blk}.mlp.fc2.bias"],
                    quant)
        t = _q(t + W[f"{blk}.ls2.gamma"] * y, quant)
        if i in m["out_indices"]:
            taps.append(_layer_norm(t, W, f"{p}.norm", quant)[:, 1:])
    return taps


def _up(x, size, quant=None):
    return _q(F.interpolate(x, size=size, mode="bilinear", align_corners=True), quant, 1)


def _rcu(W, name, x, quant):
    y = _conv(F.relu(x), W[f"{name}.conv1.weight"], W[f"{name}.conv1.bias"], quant, padding=1)
    y = _conv(F.relu(y), W[f"{name}.conv2.weight"], W[f"{name}.conv2.bias"], quant, padding=1)
    return _q(x + y, quant, 1)


def _fusion(W, name, x, skip, size, quant):
    if skip is not None:
        x = _q(x + _rcu(W, f"{name}.resConfUnit1", skip, quant), quant, 1)
    x = _up(_rcu(W, f"{name}.resConfUnit2", x, quant), size, quant)
    return _conv(x, W[f"{name}.out_conv.weight"], W[f"{name}.out_conv.bias"], quant)


def head_forward(W: dict, m: dict, taps, gh: int, gw: int, quant: str | None = None):
    """The DPT head: ``[B, 1, 14 gh, 14 gw]`` before the final ReLU."""
    h = "depth_head"
    s = f"{h}.scratch"
    outs = []
    for i, t in enumerate(taps):
        x = t.transpose(1, 2).reshape(t.shape[0], t.shape[2], gh, gw)
        x = _conv(x, W[f"{h}.projects.{i}.weight"], W[f"{h}.projects.{i}.bias"], quant)
        rl = f"{h}.resize_layers.{i}"
        if i in (0, 1):
            k = 4 if i == 0 else 2
            wt = W[f"{rl}.weight"]
            if quant:
                x, wt = _fake_quant(x, 1, quant), _fake_quant(wt, (0, 2, 3), quant)
            x = _q(F.conv_transpose2d(x, wt, W[f"{rl}.bias"], stride=k), quant, 1)
        elif i == 3:
            x = _conv(x, W[f"{rl}.weight"], W[f"{rl}.bias"], quant, stride=2, padding=1)
        outs.append(x)
    rn = [_conv(outs[i], W[f"{s}.layer{i + 1}_rn.weight"], None, quant, padding=1)
          for i in range(4)]
    path = _fusion(W, f"{s}.refinenet4", rn[3], None, rn[2].shape[2:], quant)
    path = _fusion(W, f"{s}.refinenet3", path, rn[2], rn[1].shape[2:], quant)
    path = _fusion(W, f"{s}.refinenet2", path, rn[1], rn[0].shape[2:], quant)
    path = _fusion(W, f"{s}.refinenet1", path, rn[0],
                   (2 * rn[0].shape[2], 2 * rn[0].shape[3]), quant)
    x = _conv(path, W[f"{s}.output_conv1.weight"], W[f"{s}.output_conv1.bias"], quant,
              padding=1)
    x = _up(x, (gh * PATCH, gw * PATCH), quant)
    x = F.relu(_conv(x, W[f"{s}.output_conv2.0.weight"], W[f"{s}.output_conv2.0.bias"], quant,
                     padding=1))
    x = _conv(x, W[f"{s}.output_conv2.2.weight"], W[f"{s}.output_conv2.2.bias"], quant)
    return F.relu(x) if m["trailing_head_relu"] else x


def depth_forward(W: dict, m: dict, x: torch.Tensor, quant: str | None = None):
    """``(depth [B, H, W], last tap [B, N, C])`` of normalized images ``x
    [B, 3, H, W]``."""
    h, w = x.shape[-2:]
    taps = encoder_forward(W, m, x, quant)
    depth = head_forward(W, m, taps, h // PATCH, w // PATCH, quant)
    if m["interp_to_input"] and tuple(depth.shape[-2:]) != (h, w):
        depth = _up(depth, (h, w), quant)
    return F.relu(depth)[:, 0], taps[3]
