"""SincNet's whole configuration space (replaces
``stofnet_tpu/models/sincnet_full.py``): the reference's option dict for
the CNN (``SincNetFull``) and the MLP head (``SincMLP``, JAX's ``MLP``).
The driver builds only the 4-layer ``models/sincnet.SincNet``; nothing
gives these a registry name, in either package.

- ``act_fun``'s table: relu, tanh, sigmoid, leaky_relu(0.2), elu,
  softmax (``log_softmax`` over dim 1) and linear (the identity).
- ``RefLayerNorm``: gamma * (x - mean) / (std + eps) + beta over the last
  axis, torch's unbiased std, eps added to the std.
- ``SincMLP``: per-layer dropout, act and layer/batch norm (input and per
  layer), a zero-initialized bias that exists under any norm (the
  reference re-assigns it), weights from U(+-sqrt(0.01 / (fan_in +
  fan_out))), and the reference's sequential ifs: with both norms on, the
  second branch applies ``wx`` again to the first branch's output.
- ``SincNetFull``: ``use_sinc`` on (``models/sincnet.SincConv``'s filters,
  unpadded) and off (a VALID conv), input layer/batch norm, ``get_pad``
  same padding (left = pad // 2) before the VALID conv, max-pool strides
  (floor), the final ``view(B, 1, -1)``; and ``cnn_use_laynorm``, which
  crashes upstream, as the JAX docstring defines its working equivalent:
  ``|h|`` at layer 0, the pool, then ``RefLayerNorm((C, L_pooled))`` over
  the last axis.

BatchNorm is ``models/batchnorm.py`` (flax's biased running variance;
torch momentum 0.05 = flax's 0.95), channels-last inside. Dropout draws
its masks from torch's default generator in train mode. The input length
(``input_dim``) fixes every width when the module is built, as the
reference sizes its layers.

Weights take the reference's torch names (``conv.{i}``, ``bn.{i}``,
``ln.{i}``, ``wx.{i}``, input norms ``bn0`` / ``ln0``), which is
``registry.variables_to_state_dict``'s scheme: :func:`state_from_flax`
carries a flax tree across (``params_to_state_dict`` with the options'
BatchNorm modules, then :func:`rewrite_flax_key`).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from stofnet_tpu_torch import DeviceLike, resolve_device
from stofnet_tpu_torch.models.batchnorm import BatchNorm
from stofnet_tpu_torch.models.init import materialize, torch_default_
from stofnet_tpu_torch.models.sincnet import BN_MOMENTUM, SincConv
from stofnet_tpu_torch.models.torch_import import params_to_state_dict

ACTS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "relu": F.relu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "leaky_relu": lambda x: F.leaky_relu(x, 0.2),
    "elu": F.elu,
    "softmax": lambda x: F.log_softmax(x, dim=1),
    "linear": lambda x: x,
}


def act_fun(act_type: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """The reference's activation by name."""
    return ACTS[act_type]


class RefLayerNorm(nn.Module):
    """The reference's LayerNorm over the last axis (unbiased std, eps on
    the std); ``features`` an int or a shape the affine takes."""

    def __init__(self, features, eps: float = 1e-6):
        super().__init__()
        shape = ((features,) if isinstance(features, int)
                 else tuple(features))
        self.eps = eps
        self.gamma = nn.Parameter(torch.empty(shape))
        self.beta = nn.Parameter(torch.empty(shape))
        self.reset_parameters()

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.gamma.fill_(1.0)
            self.beta.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(-1, keepdim=True)
        std = x.std(-1, keepdim=True, correction=1)
        return self.gamma * (x - mean) / (std + self.eps) + self.beta


def _dropout(x: torch.Tensor, rate: float, train: bool) -> torch.Tensor:
    """flax's Dropout: kept values scaled by 1 / (1 - rate)."""
    if not train or rate == 0.0:
        return x
    keep = 1.0 - rate
    if keep == 0.0:
        return torch.zeros_like(x)
    mask = torch.rand(x.shape, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def _mlp_draw(layer: nn.Module,
              generator: Optional[torch.Generator] = None) -> None:
    """The MLP's linear init (reference sincnet.py:345-349): U(+-sqrt(0.01
    / (fan_in + fan_out))) weights, zero bias; convs torch's default."""
    if isinstance(layer, nn.Linear):
        fan_out, fan_in = layer.weight.shape
        bound = math.sqrt(0.01 / (fan_in + fan_out))
        layer.weight.uniform_(-bound, bound, generator=generator)
        layer.bias.zero_()
    else:
        torch_default_(layer, generator)


def _batchnorm(features: int) -> BatchNorm:
    return BatchNorm(features, BN_MOMENTUM)


def get_pad(size: int, kernel_size: int, stride: int = 1,
            dilation: int = 1) -> Tuple[int, int]:
    """Reference ``get_pad`` (sincnet.py:35-55): (left, right), left =
    pad // 2."""
    pad = (((size + stride - 1) // stride - 1) * stride
           + kernel_size - size) * dilation
    return pad // 2, pad - pad // 2


def _max_pool1d(x: torch.Tensor, pool: int) -> torch.Tensor:
    """torch ``F.max_pool1d`` with kernel = stride = pool (floor)."""
    return x if pool == 1 else F.max_pool1d(x, pool, pool)


class SincMLP(nn.Module):
    """The reference's MLP head (sincnet.py:294-387) on (B, input_dim)."""

    def __init__(self, options: Mapping[str, Any],
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.options = o = dict(options)
        fc_lay: Sequence[int] = [int(n) for n in o["fc_lay"]]
        width = int(o["input_dim"])
        with torch.device("meta"):
            if o.get("fc_use_laynorm_inp"):
                self.ln0 = RefLayerNorm(width)
            if o.get("fc_use_batchnorm_inp"):
                self.bn0 = _batchnorm(width)
            self.wx = nn.ModuleList()
            self.ln, self.bn = nn.ModuleDict(), nn.ModuleDict()
            for i, n in enumerate(fc_lay):
                self.wx.append(nn.Linear(width, n))
                if o["fc_use_laynorm"][i]:
                    self.ln[str(i)] = RefLayerNorm(n)
                if o["fc_use_batchnorm"][i]:
                    self.bn[str(i)] = _batchnorm(n)
                width = n
        materialize(self, device, generator, draw=_mlp_draw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        o, train = self.options, self.training
        if o.get("fc_use_laynorm_inp"):
            x = self.ln0(x)
        if o.get("fc_use_batchnorm_inp"):
            x = self.bn0(x)
        for i, wx in enumerate(self.wx):
            use_ln = bool(o["fc_use_laynorm"][i])
            use_bn = bool(o["fc_use_batchnorm"][i])
            rate = float(o["fc_drop"][i])
            act = act_fun(o["fc_act"][i])
            # the reference's sequential ifs (:360-386): with both norms
            # on, the second branch applies wx again to the first's output
            if use_ln:
                x = _dropout(act(self.ln[str(i)](wx(x))), rate, train)
            if use_bn:
                x = _dropout(act(self.bn[str(i)](wx(x))), rate, train)
            if not use_ln and not use_bn:
                x = _dropout(act(wx(x)), rate, train)
        return x


class SincNetFull(nn.Module):
    """The reference's SincNet CNN (sincnet.py:390-497) on (B, input_dim)
    or (B, 1, input_dim): (B, 1, C_last * L_last)."""

    def __init__(self, options: Mapping[str, Any],
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.options = o = dict(options)
        n_filt = [int(n) for n in o["cnn_N_filt"]]
        len_filt = [int(k) for k in o["cnn_len_filt"]]
        pool_len = [int(p) for p in o["cnn_max_pool_len"]]
        length = int(o["input_dim"])
        self.use_sinc = bool(o.get("use_sinc", True))
        self.pads = []
        with torch.device("meta"):
            if o.get("cnn_use_laynorm_inp"):
                self.ln0 = RefLayerNorm(length)
            if o.get("cnn_use_batchnorm_inp"):
                self.bn0 = _batchnorm(length)
            self.conv = nn.ModuleList()
            self.ln, self.bn = nn.ModuleDict(), nn.ModuleDict()
            cin = 1
            for i, (n, k) in enumerate(zip(n_filt, len_filt)):
                left, right = get_pad(length, k)
                self.pads.append((left, right))
                if i == 0 and self.use_sinc:
                    conv = SincConv(n, k, float(o["fs"]))
                else:
                    conv = nn.Conv1d(cin, n, k)
                self.conv.append(conv)
                kk = conv.kernel_size if i == 0 and self.use_sinc \
                    else conv.kernel_size[0]
                length = (length + left + right - kk + 1) // pool_len[i]
                if o["cnn_use_laynorm"][i]:
                    self.ln[str(i)] = RefLayerNorm((n, length))
                elif o["cnn_use_batchnorm"][i]:
                    self.bn[str(i)] = _batchnorm(n)
                cin = n
        materialize(self, device, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        o, train = self.options, self.training
        if o.get("cnn_use_laynorm_inp"):
            x = self.ln0(x)
        if o.get("cnn_use_batchnorm_inp"):
            x = self.bn0(x)  # per-feature statistics of (B, D)
        batch = x.shape[0]
        x = x.reshape(batch, 1, -1)
        for i, conv in enumerate(self.conv):
            act = act_fun(o["cnn_act"][i])
            rate = float(o["cnn_drop"][i])
            pool = int(o["cnn_max_pool_len"][i])
            xp = F.pad(x, self.pads[i])
            if i == 0 and self.use_sinc:
                h = F.conv1d(xp, conv.filters())
            else:
                h = conv(xp)
            if str(i) in self.ln:
                # the working equivalent of the path broken upstream
                if i == 0:
                    h = torch.abs(h)
                h = self.ln[str(i)](_max_pool1d(h, pool))
            elif str(i) in self.bn:
                h = _max_pool1d(h, pool)
                h = self.bn[str(i)](h.transpose(1, 2)).transpose(1, 2)
            else:
                h = _max_pool1d(h, pool)
            x = _dropout(act(h), rate, train)
        return x.reshape(batch, 1, -1)


def rewrite_flax_key(key: str) -> str:
    """flax scopes -> the reference's torch names: ``conv{i}`` ->
    ``conv.{i}``, likewise ``bn``, ``wx`` and ``ln``; the input norms
    ``bn_inp`` / ``ln_inp`` -> ``bn0`` / ``ln0``."""
    head, rest = key.split(".", 1)
    if head == "bn_inp":
        return "bn0." + rest
    if head == "ln_inp":
        return "ln0." + rest
    for prefix in ("conv", "bn", "wx", "ln"):
        if head.startswith(prefix) and head[len(prefix):].isdigit():
            return f"{prefix}.{head[len(prefix):]}." + rest
    return key


def batchnorm_modules(options: Mapping[str, Any],
                      mlp: bool = False) -> Tuple[str, ...]:
    """The flax BatchNorm scopes of an option dict."""
    mods = []
    if options.get("fc_use_batchnorm_inp" if mlp
                   else "cnn_use_batchnorm_inp"):
        mods.append("bn_inp")
    flags = options["fc_use_batchnorm"] if mlp else options[
        "cnn_use_batchnorm"]
    mods.extend(f"bn{i}" for i, on in enumerate(flags) if on)
    return tuple(mods)


def state_from_flax(variables: Mapping[str, Any], options: Mapping[str, Any],
                    mlp: bool = False) -> Dict[str, torch.Tensor]:
    """A flax ``SincNetFull`` (or ``MLP`` with ``mlp=True``) tree -> the
    port's state dict of CPU tensors."""
    sd = params_to_state_dict(dict(variables),
                              batchnorm_modules(options, mlp=mlp))
    return {rewrite_flax_key(k): torch.from_numpy(np.array(v))
            for k, v in sd.items()}
