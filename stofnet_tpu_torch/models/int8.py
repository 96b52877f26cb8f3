"""Post-training-quantized (int8) StofNet serving path (replaces
``stofnet_tpu/models/int8.py``).

The StofNet forward over a quantized state: the SemiGlobalBlock's contract
conv runs s8 x s8 -> s32 (``ops/int8.py``) and its (B, L, 512) pre-pool
tensor is requantized to s8 in the conv's epilogue, so the 80x max-pool
runs on the codes. The scheme, as the JAX package's:

- **weights**: per-output-channel symmetric s8 of the raw kernel;
- **activations**: per-waveform symmetric s8 with a dynamic scale
  ``max|h_row|/127``, so each waveform's codes (and its decode) are
  independent of its batch neighbours;
- **pre-pool requantization**: a per-channel scale calibrated on a
  representative batch with 1.25x headroom. Requantization is monotone,
  so the max-pool commutes with it exactly.

``stack_layers`` also runs the chosen k=7 stack convs in s8 (dynamic
per-waveform input scales), optionally with SmoothQuant-style channel
equalization (``eq_alpha``) and PTQ bias correction (``bias_correct``).
Everything else stays in ``dtype``: conv1, the expand conv, conv_last,
the residual carries and the decode.

Float convs go through ``ops/conv.py:conv1d_same``, the counterpart of
the JAX path's ``ops/packed_conv.conv1d_same``, so the casts sit where
JAX's do. The state is a nested dict of tensors, with the keys of the JAX
package's quantized pytree, on the weights' device.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from stofnet_tpu_torch.ops.conv import conv1d_same, full_f32
from stofnet_tpu_torch.ops.int8 import (
    INT8_MAX, absmax_scale, conv1d_same_int8, quantize, quantize_weight,
)
from stofnet_tpu_torch.ops.shuffle import sample_shuffle

# the architecture arguments the int8 forward takes; the rest of it
# follows the weights' shapes
QCONFIG = ("upsample_factor", "num_blocks", "semi_global_scale")
PRE_SCALE_HEADROOM = 1.25
CONTRACT = "semi_global_block.contract_conv"
EXPAND = "semi_global_block.expand_conv"


def _kb(state: Mapping[str, torch.Tensor], name: str
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Torch (O, I, K) weight -> (K, I, O) f32 kernel, and the f32 bias."""
    return (state[f"{name}.weight"].permute(2, 1, 0).to(torch.float32),
            state[f"{name}.bias"].to(torch.float32))


def _input(state: Mapping[str, torch.Tensor], x) -> torch.Tensor:
    """``x`` (B, C, L) as an f32 (B, L, C) tensor on the state's device."""
    dev = state["conv1.weight"].device
    return torch.as_tensor(x).to(dev, torch.float32).transpose(1, 2)


def _pool(v: torch.Tensor, scale: int) -> torch.Tensor:
    """Max over windows of ``scale`` positions, the tail dropped."""
    rows = v.shape[1] // scale
    return v[:, :rows * scale].reshape(v.shape[0], rows, scale,
                                       v.shape[2]).amax(2)


def _repeat_pad(s: torch.Tensor, scale: int, length: int) -> torch.Tensor:
    """The pooled pathway back at ``length``: repeated ``scale`` times and
    padded by half the shortfall on each side."""
    s = torch.repeat_interleave(s, scale, dim=1)
    pad = max(0, length - s.shape[1])
    return F.pad(s, (0, 0, pad // 2, pad // 2))


def _f32_trunk(state: Mapping[str, torch.Tensor], x,
               semi_global_scale: int) -> torch.Tensor:
    """f32 forward up to the stack's input: conv1 + ReLU and the
    SemiGlobalBlock (StofNet's own function, in f32)."""
    h = F.relu(conv1d_same(_input(state, x), *_kb(state, "conv1")))
    if semi_global_scale != 1:
        s = _pool(conv1d_same(h, *_kb(state, CONTRACT)), semi_global_scale)
        s = torch.where(s >= 0, s, 0.01 * s)
        s = F.leaky_relu(conv1d_same(s, *_kb(state, EXPAND)), 0.01)
        h = h + _repeat_pad(s, semi_global_scale, h.shape[1])
    return h


def _prepool_absmax(state: Mapping[str, torch.Tensor], x) -> torch.Tensor:
    """Per-channel absmax (1, 1, F) of the contract conv's output in the
    f32 forward: the pre-pool requantization scale's basis."""
    h = F.relu(conv1d_same(_input(state, x), *_kb(state, "conv1")))
    v = conv1d_same(h, *_kb(state, CONTRACT))
    return v.abs().amax(dim=(0, 1), keepdim=True)


def _stack_input_absmax(state: Mapping[str, torch.Tensor], x,
                        num_blocks: int = 13, semi_global_scale: int = 80
                        ) -> Dict[str, torch.Tensor]:
    """f32 forward through the stack, collecting each stack conv's input
    per-channel absmax (1, 1, Cin): the activation side of the
    equalization basis."""
    h = _f32_trunk(state, x, semi_global_scale)
    absmax = {}
    residual_layers = set(range(3, num_blocks - 1, 2))
    res = h
    for i in range(2, num_blocks - 1):
        absmax[f"conv{i}"] = h.abs().amax(dim=(0, 1), keepdim=True)
        y = conv1d_same(h, *_kb(state, f"conv{i}"))
        if i in residual_layers:
            h = res = res + y
        else:
            h = F.leaky_relu(y, 0.01)
    absmax[f"conv{num_blocks - 1}"] = h.abs().amax(dim=(0, 1), keepdim=True)
    return absmax


def _stack_bias_deltas(state: Mapping[str, torch.Tensor], calib_x,
                       q: Dict[str, Any], chosen: Sequence[int],
                       num_blocks: int = 13, semi_global_scale: int = 80,
                       impl: str = "conv") -> Dict[str, torch.Tensor]:
    """Per-output-channel mean quantization error ``E[conv_f32(h) -
    qconv(h)]`` over (B, L) of each chosen stack conv, with ``h`` the f32
    forward's layer input (PTQ bias correction): added to the stored
    bias, it cancels the mean of each channel's rounding error."""
    h = _f32_trunk(state, calib_x, semi_global_scale)
    deltas = {}
    residual_layers = set(range(3, num_blocks - 1, 2))
    res = h
    for i in range(2, num_blocks):
        y = conv1d_same(h, *_kb(state, f"conv{i}"))
        if i in chosen:
            yq = _qconv(h, q["stack"][f"conv{i}"], impl)
            deltas[f"conv{i}"] = (y - yq).mean(dim=(0, 1))
        if i == num_blocks - 1:  # its output feeds the global skip only
            break
        if i in residual_layers:
            h = res = res + y
        else:
            h = F.leaky_relu(y, 0.01)
    return deltas


def _norm_stack_layers(quant_stack: bool, stack_layers: Optional[Sequence],
                       num_blocks: int) -> Tuple[int, ...]:
    """The stack convs to run in int8: ``stack_layers`` (indices in
    [2, num_blocks-1]) when given, else all or none by ``quant_stack``.
    A sorted tuple."""
    if stack_layers is not None:
        bad = [i for i in stack_layers if not 2 <= i <= num_blocks - 1]
        if bad:
            raise ValueError(f"stack_layers out of range [2, {num_blocks - 1}]"
                             f": {bad}")
        return tuple(sorted(set(int(i) for i in stack_layers)))
    return tuple(range(2, num_blocks)) if quant_stack else ()


@torch.inference_mode()
@full_f32()
def quantize_stofnet(state: Mapping[str, torch.Tensor], calib_x,
                     upsample_factor: int = 4, num_blocks: int = 13,
                     semi_global_scale: int = 80, quant_stack: bool = False,
                     stack_layers: Optional[Sequence[int]] = None,
                     eq_alpha: Optional[float] = None,
                     bias_correct: bool = False) -> Dict[str, Any]:
    """The int8 serving state of a StofNet state dict (reference torch
    names), on the state's device.

    ``calib_x`` is a representative (B, 1, L) batch (a tensor or an
    array): it calibrates the pre-pool requantization scales and, with
    ``eq_alpha``, the stack's equalization basis; activation input scales
    stay dynamic at run time. Calibrate on echo-bearing data.

    ``quant_stack=True`` / ``stack_layers=(i, ...)`` also build s8 twins
    of all / the chosen k=7 stack convs. ``eq_alpha`` (0..1) equalizes
    each quantized stack conv per input channel c with
    ``s_c = amax_c^alpha / wmax_c^(1-alpha)`` (``amax`` the calibrated
    input absmax, ``wmax`` the kernel's per-Cin absmax): the conv computes
    ``conv(h / s, w * s)``. ``bias_correct`` adds each quantized stack
    conv's calibrated mean rounding error to its bias.

    The calibration's f32 forwards run without TF32 (``full_f32``), as
    JAX's sum in full f32.
    """
    q: Dict[str, Any] = {"f32": {}}
    for name in ["conv1", "conv_last"] + [f"conv{i}" for i in
                                          range(2, num_blocks)]:
        k, b = _kb(state, name)
        q["f32"][name] = {"kernel": k, "bias": b}

    if semi_global_scale != 1:
        k, b = _kb(state, EXPAND)
        q["f32"]["expand"] = {"kernel": k, "bias": b}
        k, b = _kb(state, CONTRACT)
        wq, ws = quantize_weight(k)
        pre = _prepool_absmax(state, calib_x)
        # a dead (all-zero) pre-pool channel requantizes as a no-op
        pre = torch.where(pre > 0, pre, torch.full_like(pre, INT8_MAX))
        pre_scale = pre * PRE_SCALE_HEADROOM / INT8_MAX
        q["contract"] = {"wq": wq, "wscale": ws, "bias": b,
                         "pre_scale": pre_scale}

    chosen = _norm_stack_layers(quant_stack, stack_layers, num_blocks)
    if chosen:
        amax = (_stack_input_absmax(state, calib_x, num_blocks,
                                    semi_global_scale)
                if eq_alpha is not None else None)
        q["stack"] = {}
        for i in chosen:
            k, b = _kb(state, f"conv{i}")
            layer = {"bias": b}
            if eq_alpha is not None:
                a = amax[f"conv{i}"][0].clamp_min(1e-12)  # (1, Cin)
                wmax = k.abs().amax(dim=(0, 2))[None, :].clamp_min(1e-12)
                s = a ** eq_alpha / wmax ** (1.0 - eq_alpha)
                s = torch.where((a > 1e-10) & (wmax > 1e-10), s,
                                torch.ones_like(s))
                layer["inv_eq"] = (1.0 / s)[None]
                k = k * s[0][None, :, None]
            wq, ws = quantize_weight(k)
            layer.update(wq=wq, wscale=ws)
            q["stack"][f"conv{i}"] = layer
        if bias_correct:
            deltas = _stack_bias_deltas(state, calib_x, q, chosen,
                                        num_blocks, semi_global_scale)
            for i in chosen:
                lay = q["stack"][f"conv{i}"]
                lay["bias"] = lay["bias"] + deltas[f"conv{i}"]
    return q


def _dyn_quant(h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-waveform symmetric s8, scale (B, 1, 1) = row
    absmax/127: per row, so each waveform's codes do not depend on what it
    is batched with."""
    hf = h.to(torch.float32)
    scale = absmax_scale(hf, dim=(1, 2))
    return quantize(hf, scale), scale


def _qconv(h: torch.Tensor, layer: Mapping[str, torch.Tensor],
           impl: str) -> torch.Tensor:
    """Quantize the activation per waveform (after the equalization
    rescale, where the layer has one), run the s8 conv, dequantize with
    the row scale times the per-channel weight scale, add the bias."""
    hf = h.to(torch.float32)
    if "inv_eq" in layer:
        hf = hf * layer["inv_eq"]
    scale = absmax_scale(hf, dim=(1, 2))
    acc = conv1d_same_int8(quantize(hf, scale), layer["wq"], impl=impl)
    return (acc.to(torch.float32) * (scale * layer["wscale"])
            + layer["bias"])


def stofnet_apply_int8(q: Mapping[str, Any], x: torch.Tensor,
                       upsample_factor: int = 4, num_blocks: int = 13,
                       semi_global_scale: int = 80,
                       dtype: Optional[torch.dtype] = torch.bfloat16,
                       impl: str = "conv", quant_stack: bool = False,
                       stack_layers: Optional[Sequence[int]] = None
                       ) -> torch.Tensor:
    """StofNet forward, (B, 1, L) -> (B, 1, L*r) f32, with the int8 SGB
    contract conv, at any L the module takes (``L // semi_global_scale``
    pooled rows, the pathway padded back by half the shortfall on each
    side).

    ``impl`` picks the s8 conv's form (``ops/int8.py``). ``quant_stack`` /
    ``stack_layers`` must name the stack convs ``q`` was built with.
    """
    h = x.transpose(1, 2)
    if dtype is not None:
        h = h.to(dtype)
    f32 = q["f32"]
    h = F.relu(conv1d_same(h, f32["conv1"]["kernel"], f32["conv1"]["bias"],
                           dtype))

    if semi_global_scale != 1:
        c = q["contract"]
        xq, s_in = _dyn_quant(h)
        acc = conv1d_same_int8(xq, c["wq"], impl=impl)
        # requantize the pre-pool tensor to s8 in the conv's epilogue;
        # JAX's order of operations, so ties round the same way
        m = s_in * c["wscale"] / c["pre_scale"]
        v = acc.to(torch.float32).mul_(m).add_(c["bias"] / c["pre_scale"])
        del acc
        qpre = v.round_().clamp_(-INT8_MAX, INT8_MAX).to(torch.int8)
        del v
        pooled = _pool(qpre, semi_global_scale).to(torch.float32)
        pooled = pooled * c["pre_scale"]  # dequantize the max
        pooled = torch.where(pooled >= 0, pooled, 0.01 * pooled)
        if dtype is not None:
            pooled = pooled.to(dtype)
        s = conv1d_same(pooled, f32["expand"]["kernel"],
                        f32["expand"]["bias"], dtype)
        s = F.leaky_relu(s, 0.01)
        h = h + _repeat_pad(s, semi_global_scale, h.shape[1])

    chosen = _norm_stack_layers(quant_stack, stack_layers, num_blocks)

    def stack_conv(h, i):
        if i in chosen:
            y = _qconv(h, q["stack"][f"conv{i}"], impl)
        else:
            y = conv1d_same(h, f32[f"conv{i}"]["kernel"],
                            f32[f"conv{i}"]["bias"], dtype)
        return y.to(dtype) if dtype is not None else y

    residual_layers = set(range(3, num_blocks - 1, 2))
    res = res1 = h
    for i in range(2, num_blocks - 1):
        y = stack_conv(h, i)
        if i in residual_layers:
            h = res = res + y
        else:
            h = F.leaky_relu(y, 0.01)
    h = res1 + stack_conv(h, num_blocks - 1)
    h = conv1d_same(h, f32["conv_last"]["kernel"], f32["conv_last"]["bias"],
                    dtype)
    return sample_shuffle(h.transpose(1, 2), upsample_factor).to(
        torch.float32)
