"""Actor-critic policy networks (port of ``pyflyt_tpu/rl/networks.py``).

Separate tanh trunks for the policy and the value, a linear mean head, a
state-independent log-std and a linear value head, with the JAX module's
orthogonal init gains (√2 on trunk layers, 0.01 on the policy head, 1.0 on
the value head) and zero biases. ``forward`` is the f32 path
(``network.apply`` in the JAX package); ``kernel_weights`` hands the fused
CUDA forward (ops/cuda_policy.py) its bf16 weights, converted once and
again only after a parameter changes.

``VisionActorCritic`` (the Gates task's conv policy) has no kernel: the
JAX package computes its convs with ``lax.conv_general_dilated``, outside
any Pallas kernel, and the port with ``F.conv2d``.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from pyflyt_tpu_torch.device import resolve_device
from pyflyt_tpu_torch.ops import cuda_policy


def _dense(d_in: int, d_out: int, gain: float, generator: torch.Generator | None) -> nn.Linear:
    lin = nn.Linear(d_in, d_out)
    _init_dense_(lin, gain, generator)
    return lin


@torch.no_grad()
def _init_dense_(lin: nn.Linear, gain: float, generator: torch.Generator | None) -> None:
    """Orthogonal ``gain`` weights drawn on the CPU from ``generator``, zero
    bias, wherever the layer lives."""
    w = torch.empty(lin.weight.shape)
    nn.init.orthogonal_(w, gain=gain, generator=generator)
    lin.weight.copy_(w)
    lin.bias.zero_()


def clamp_log_std(log_std: Tensor, log_std_range: tuple[float, float] | None) -> Tensor:
    """``log_std`` clipped to ``log_std_range``. Written as
    ``minimum(maximum(x, lo), hi)``, as ``jnp.clip`` is, so a value exactly
    on a bound takes half the gradient (``torch.clamp`` would pass all of
    it)."""
    if log_std_range is None:
        return log_std
    lo, hi = (log_std.new_tensor(v) for v in log_std_range)
    return torch.minimum(torch.maximum(log_std, lo), hi)


class MLP(nn.Module):
    """Stack of dense layers with tanh (also after the last unless
    ``activate_last`` is False)."""

    def __init__(
        self,
        in_dim: int,
        sizes: Sequence[int],
        activate_last: bool = True,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        dims = [in_dim, *sizes]
        self.layers = nn.ModuleList(
            _dense(dims[i], dims[i + 1], math.sqrt(2.0), generator) for i in range(len(sizes))
        )
        self.activate_last = activate_last

    def forward(self, x: Tensor) -> Tensor:
        for i, lin in enumerate(self.layers):
            x = lin(x)
            if self.activate_last or i < len(self.layers) - 1:
                x = torch.tanh(x)
        return x


class ActorCritic(nn.Module):
    """Separate actor/critic tanh MLPs + diagonal Gaussian policy.

    Initialised on the CPU from ``generator`` (seeded init), then moved to
    ``device``.
    """

    def __init__(
        self,
        obs_dim: int,
        action_dim: int,
        feature_sizes: Sequence[int] = (256, 256),
        pi_sizes: Sequence[int] = (),
        vf_sizes: Sequence[int] = (),
        init_log_std: float = 0.0,
        log_std_range: tuple[float, float] | None = None,
        device: str | torch.device = "cuda",
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        dev = resolve_device(device)
        self.obs_dim = obs_dim
        self.action_dim = action_dim
        self.log_std_range = log_std_range
        pi = (*feature_sizes, *pi_sizes)
        vf = (*feature_sizes, *vf_sizes)
        self.pi_trunk = MLP(obs_dim, pi, generator=generator)
        self.pi_head = _dense(pi[-1] if pi else obs_dim, action_dim, 0.01, generator)
        self.log_std = nn.Parameter(torch.full((action_dim,), float(init_log_std)))
        self.vf_trunk = MLP(obs_dim, vf, generator=generator)
        self.vf_head = _dense(vf[-1] if vf else obs_dim, 1, 1.0, generator)
        self.to(dev)
        self._kw: cuda_policy.PolicyWeights | None = None
        self._kw_key: tuple | None = None

    def clamped_log_std(self) -> Tensor:
        """``log_std`` clipped to ``log_std_range`` (``clamp_log_std``)."""
        return clamp_log_std(self.log_std, self.log_std_range)

    def forward(self, obs: Tensor) -> tuple[Tensor, Tensor, Tensor]:
        """Returns ``(action_mean, log_std, value)`` in f32."""
        mean = self.pi_head(self.pi_trunk(obs))
        value = self.vf_head(self.vf_trunk(obs))
        return mean, self.clamped_log_std().expand_as(mean), value[..., 0]

    def value(self, obs: Tensor) -> Tensor:
        """The critic alone, in f32: ``forward(obs)[2]``."""
        return self.vf_head(self.vf_trunk(obs))[..., 0]

    def kernel_weights(self) -> cuda_policy.PolicyWeights:
        """bf16 weights for the fused forward, rebuilt only when a
        parameter was replaced or modified in place."""
        key = tuple((p.data_ptr(), p._version) for p in self.parameters())
        if self._kw is None or key != self._kw_key:
            self._kw = cuda_policy.prepare_weights(
                cuda_policy.params_to_leaves(self),
                n_pi=len(self.pi_trunk.layers), n_vf=len(self.vf_trunk.layers),
            )
            self._kw_key = key
        return self._kw


CONV_IMPLS = ("conv", "im2col", "s2d")


def same_pads(size: int) -> tuple[int, int]:
    """(before, after) padding of a 3 × 3 stride-2 ``"SAME"`` conv over
    ``size`` pixels, as XLA pads: ``total = (ceil(size/2) − 1)·2 + 3 −
    size``, ``before = total // 2``. An even size pads 0 before and 1
    after; ``Conv2d(padding=1)`` would pad 1 on both sides and shift the
    output by a pixel."""
    total = max((-(-size // 2) - 1) * 2 + 3 - size, 0)
    return total // 2, total - total // 2


def encoded_size(image_shape: tuple, conv_features: Sequence[int]) -> int:
    """The width of the encoder's flat output: ``ceil(·/2)`` of the extent
    a layer, times the last layer's features (the image itself without
    convs)."""
    if not conv_features:
        return math.prod(image_shape)
    h, w = image_shape[1], image_shape[2]
    for _ in conv_features:
        h, w = -(-h // 2), -(-w // 2)
    return h * w * conv_features[-1]


class VisionActorCritic(nn.Module):
    """Actor-critic for image + vector dict observations (the Gates task):
    the JAX package's ``VisionActorCritic``.

    It takes the flat observation ``rl/ppo._flat_obs`` builds (sorted
    keys): ``obs[..., image_offset : image_offset + C·H·W]`` is the raw
    ``rgba_cam`` ``(C, H, W)``, scaled by 1/255 here, the rest the vector
    features. A shared encoder of 3 × 3 stride-2 ``"SAME"`` convs with ReLU
    (lecun-normal kernels, zero bias; the padding written out by
    ``same_pads``, then ``F.conv2d`` unpadded) is flattened in NHWC order,
    as flax flattens, so the first dense layer's weights are flax's
    transposed and nothing more; the features, then the vector, feed
    separate tanh ``pi``/``vf`` trunks and the heads of ``ActorCritic``.

    ``conv_impl`` takes the JAX module's three lowerings, ``"conv"``,
    ``"im2col"`` and ``"s2d"``: exact reformulations of one function with
    one parameter tree there, so all three run the same ``F.conv2d`` here.

    Initialised on the CPU from ``generator``, then moved to ``device``;
    ``reset_parameters`` draws the same init again in place.
    """

    def __init__(
        self,
        obs_dim: int,
        action_dim: int,
        image_offset: int,
        image_shape: tuple,
        conv_features: Sequence[int] = (16, 32, 32),
        feature_sizes: Sequence[int] = (128,),
        pi_sizes: Sequence[int] = (),
        vf_sizes: Sequence[int] = (),
        init_log_std: float = 0.0,
        log_std_range: tuple[float, float] | None = None,
        conv_impl: str = "conv",
        device: str | torch.device = "cuda",
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        if conv_impl not in CONV_IMPLS:
            raise ValueError(f"unknown conv impl {conv_impl!r}")
        dev = resolve_device(device)
        self.obs_dim, self.action_dim = obs_dim, action_dim
        self.image_offset = int(image_offset)
        self.image_shape = tuple(int(v) for v in image_shape)
        self.conv_features = tuple(int(f) for f in conv_features)
        self.conv_impl = conv_impl
        self.init_log_std = float(init_log_std)
        self.log_std_range = log_std_range
        c = self.image_shape[0]
        self.image_size = math.prod(self.image_shape)
        self.convs = nn.ModuleList()
        for f in self.conv_features:
            self.convs.append(nn.Conv2d(c, f, 3, stride=2, padding=0))
            c = f
        feat = encoded_size(self.image_shape, self.conv_features) + obs_dim - self.image_size
        pi = (*feature_sizes, *pi_sizes)
        vf = (*feature_sizes, *vf_sizes)
        self.pi_trunk = MLP(feat, pi)
        self.pi_head = nn.Linear(pi[-1] if pi else feat, action_dim)
        self.log_std = nn.Parameter(torch.empty(action_dim))
        self.vf_trunk = MLP(feat, vf)
        self.vf_head = nn.Linear(vf[-1] if vf else feat, 1)
        self.reset_parameters(generator)
        self.to(dev)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """flax's init, drawn on the CPU from ``generator``: lecun-normal
        conv kernels (a normal truncated at ±2σ, σ = √(1/fan_in)/0.8796),
        orthogonal dense layers (√2, the heads 0.01 and 1.0), zero biases,
        ``log_std`` at ``init_log_std``."""
        for conv in self.convs:
            fan_in = conv.in_channels * 9
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            w = torch.empty(conv.weight.shape)
            nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
            conv.weight.copy_(w)
            conv.bias.zero_()
        for trunk in (self.pi_trunk, self.vf_trunk):
            for lin in trunk.layers:
                _init_dense_(lin, math.sqrt(2.0), generator)
        _init_dense_(self.pi_head, 0.01, generator)
        _init_dense_(self.vf_head, 1.0, generator)
        self.log_std.fill_(self.init_log_std)

    def clamped_log_std(self) -> Tensor:
        """``log_std`` clipped to ``log_std_range`` (``clamp_log_std``)."""
        return clamp_log_std(self.log_std, self.log_std_range)

    def features(self, obs: Tensor) -> Tensor:
        """The trunks' input ``(..., feat)``: the encoded image, then the
        vector features."""
        lead = obs.shape[:-1]
        obs = obs.reshape(-1, obs.shape[-1])
        i0, n = self.image_offset, self.image_size
        vec = torch.cat([obs[:, :i0], obs[:, i0 + n :]], dim=-1)
        x = obs[:, i0 : i0 + n].reshape(-1, *self.image_shape).to(torch.float32) / 255.0
        for conv in self.convs:
            (ph0, ph1), (pw0, pw1) = same_pads(x.shape[-2]), same_pads(x.shape[-1])
            x = F.relu(F.conv2d(F.pad(x, (pw0, pw1, ph0, ph1)), conv.weight, conv.bias, stride=2))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC, as flax flattens
        return torch.cat([x, vec.to(x.dtype)], dim=-1).reshape(*lead, -1)

    def forward(self, obs: Tensor) -> tuple[Tensor, Tensor, Tensor]:
        """Returns ``(action_mean, log_std, value)`` in f32."""
        feat = self.features(obs)
        mean = self.pi_head(self.pi_trunk(feat))
        value = self.vf_head(self.vf_trunk(feat))
        return mean, self.clamped_log_std().expand_as(mean), value[..., 0]

    def value(self, obs: Tensor) -> Tensor:
        """The critic alone, in f32 (the encoder included)."""
        return self.vf_head(self.vf_trunk(self.features(obs)))[..., 0]


def gaussian_log_prob(mean: Tensor, log_std: Tensor, action: Tensor) -> Tensor:
    """Diagonal Gaussian log-density, summed over action dims."""
    var = torch.exp(2.0 * log_std)
    lp = -0.5 * ((action - mean) ** 2 / var + 2.0 * log_std + math.log(2.0 * math.pi))
    return torch.sum(lp, dim=-1)


def gaussian_entropy(log_std: Tensor) -> Tensor:
    """Diagonal Gaussian entropy, summed over action dims."""
    return torch.sum(log_std + 0.5 * math.log(2.0 * math.pi * math.e), dim=-1)
