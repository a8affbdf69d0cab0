"""Planted faults of Restormer's forward (``models/restormer.py``), for the
checks that must catch them: ``tests/test_torch_port_restormer.py`` on the
CPU, and ``scripts/restormer_card.py faults`` through the benchmark's
comparison on the card.

Each fault stands in for ``restormer.attention_maps``,
``restormer.depthwise`` or ``restormer.pointwise`` (same signature) and is
written in plain PyTorch, or runs the kernel with one part left out:

* ``no_temperature``: the attention without its learned temperature;
* ``k_unnormalised``: k's L2 normalisation left out;
* ``tanh_gelu``: GDFN's gate with GELU in its tanh form;
* ``heads_swapped``: one head's attention applied to another head's v;
* ``no_row_scale``: LayerNorm's row scale left out of the 1×1 convs that
  fold it (K9's epilogue without r; the folded weight kept).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from celebrity_image_denoiser_tpu_torch.models import restormer
from celebrity_image_denoiser_tpu_torch.ops.cuda import channel_attention
from celebrity_image_denoiser_tpu_torch.ops.cuda import dwconv3x3

_ATTENTION, _DEPTHWISE = restormer.attention_maps, restormer.depthwise
_POINTWISE = restormer.pointwise


def no_temperature(qkv, heads, temperature, route):
    return _ATTENTION(qkv, heads, torch.ones_like(temperature), route)


def k_unnormalised(qkv, heads, temperature, route):
    q, k = channel_attention.heads_of(qkv, heads)
    q = F.normalize(q, dim=-1)
    a = (q @ k.transpose(-2, -1)) * temperature.view(1, heads, 1, 1)
    return a.softmax(dim=-1)


def heads_swapped(qkv, heads, temperature, route):
    return _ATTENTION(qkv, heads, temperature, route).roll(1, dims=1)


def tanh_gelu(x, w, gate, route):
    if not gate:
        return _DEPTHWISE(x, w, gate, route)
    y = dwconv3x3.dwconv3x3_plain(x, w)
    c = y.shape[3] // 2
    return (F.gelu(y[..., :c], approximate="tanh") * y[..., c:]).contiguous()


def no_row_scale(a, w, layer_norm, residual, route, w_tf32=None):
    return _POINTWISE(a, w, False, residual, route, w_tf32)


# name → (what it stands in for, the fault)
FAULTS = {
    "no_temperature": ("attention_maps", no_temperature),
    "k_unnormalised": ("attention_maps", k_unnormalised),
    "tanh_gelu": ("depthwise", tanh_gelu),
    "heads_swapped": ("attention_maps", heads_swapped),
    "no_row_scale": ("pointwise", no_row_scale),
}


@contextlib.contextmanager
def planted(name):
    """Restormer's forward with the fault ``name`` (None: sound) for the
    length of the ``with``."""
    if name is None:
        yield
        return
    attr, fault = FAULTS[name]
    setattr(restormer, attr, fault)
    try:
        yield
    finally:
        restormer.attention_maps, restormer.depthwise = _ATTENTION, _DEPTHWISE
        restormer.pointwise = _POINTWISE
