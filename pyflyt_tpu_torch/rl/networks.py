"""Actor-critic policy networks (port of ``pyflyt_tpu/rl/networks.py``).

Separate tanh trunks for the policy and the value, a linear mean head, a
state-independent log-std and a linear value head, with the JAX module's
orthogonal init gains (√2 on trunk layers, 0.01 on the policy head, 1.0 on
the value head) and zero biases. ``forward`` is the f32 path
(``network.apply`` in the JAX package); ``kernel_weights`` hands the fused
CUDA forward (ops/cuda_policy.py) its bf16 weights, converted once and
again only after a parameter changes.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import Tensor, nn

from pyflyt_tpu_torch.device import resolve_device
from pyflyt_tpu_torch.ops import cuda_policy


def _dense(d_in: int, d_out: int, gain: float, generator: torch.Generator | None) -> nn.Linear:
    lin = nn.Linear(d_in, d_out)
    nn.init.orthogonal_(lin.weight, gain=gain, generator=generator)
    nn.init.zeros_(lin.bias)
    return lin


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
        """``log_std`` clipped to ``log_std_range``. Written as
        ``minimum(maximum(x, lo), hi)``, as ``jnp.clip`` is, so a value
        exactly on a bound takes half the gradient (``torch.clamp`` would
        pass all of it)."""
        if self.log_std_range is None:
            return self.log_std
        lo, hi = (self.log_std.new_tensor(v) for v in self.log_std_range)
        return torch.minimum(torch.maximum(self.log_std, lo), hi)

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


def gaussian_log_prob(mean: Tensor, log_std: Tensor, action: Tensor) -> Tensor:
    """Diagonal Gaussian log-density, summed over action dims."""
    var = torch.exp(2.0 * log_std)
    lp = -0.5 * ((action - mean) ** 2 / var + 2.0 * log_std + math.log(2.0 * math.pi))
    return torch.sum(lp, dim=-1)


def gaussian_entropy(log_std: Tensor) -> Tensor:
    """Diagonal Gaussian entropy, summed over action dims."""
    return torch.sum(log_std + 0.5 * math.log(2.0 * math.pi * math.e), dim=-1)
