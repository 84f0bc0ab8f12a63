"""Checkpoints of the whole training state (port of
``pyflyt_tpu/rl/checkpoint.py``) with ``torch.save``.

A checkpoint holds the network's parameters, Adam's count and moments, the
env state (the auto-reset cache included), the observations, the state of
every ``torch.Generator`` in the runner and ``update_idx``, so training
resumes bit for bit. Generators shared inside the runner (the packed env
state and its auto-reset cache draw from one) stay shared after a restore.

Orbax checkpoints of the JAX package are not read here (the port imports
no orbax): ``pyflyt_tpu.rl.checkpoint.restore_params`` gives their params
as numpy, and ``convert.actor_critic_from_flax`` (or
``vision_actor_critic_from_flax``) builds the network.
``save_policy_npz`` writes such a network as a plain ``.npz`` of its
f32 parameters, which ``load_policy_npz`` reads with numpy and torch
alone; the archived policies the port ships live in
``pyflyt_tpu_torch/assets/policies/``.
"""

from __future__ import annotations

import copy
import dataclasses
import math
import os
from typing import Any

import numpy as np
import torch
from torch import Tensor, nn

from pyflyt_tpu_torch.device import resolve_device
from pyflyt_tpu_torch.rl.networks import ActorCritic, VisionActorCritic, encoded_size

POLICY_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets", "policies")


def _dump(obj: Any, gens: list, ids: dict) -> Any:
    if isinstance(obj, torch.Generator):
        k = ids.setdefault(id(obj), len(ids))
        if k == len(gens):
            gens.append(obj.get_state())
        return {"__generator__": k}
    if isinstance(obj, Tensor):
        return obj.detach()
    if isinstance(obj, nn.Module):
        return {"__module__": obj.state_dict()}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _dump(getattr(obj, f.name), gens, ids) for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_dump(x, gens, ids) for x in obj)
    if isinstance(obj, dict):
        return {k: _dump(v, gens, ids) for k, v in obj.items()}
    return obj


def _load(tmpl: Any, saved: Any, gens: list, made: dict) -> Any:
    if isinstance(tmpl, torch.Generator):
        k = saved["__generator__"]
        if k not in made:
            g = torch.Generator(device=tmpl.device)
            g.set_state(gens[k])
            made[k] = g
        return made[k]
    if isinstance(tmpl, Tensor):
        return saved.to(device=tmpl.device, dtype=tmpl.dtype, copy=True)
    if isinstance(tmpl, nn.Module):
        net = copy.deepcopy(tmpl)
        net.load_state_dict(saved["__module__"])
        return net
    if dataclasses.is_dataclass(tmpl) and not isinstance(tmpl, type):
        return dataclasses.replace(tmpl, **{
            f.name: _load(getattr(tmpl, f.name), saved[f.name], gens, made)
            for f in dataclasses.fields(tmpl) if f.init
        })
    if isinstance(tmpl, (list, tuple)):
        if len(tmpl) != len(saved):
            raise ValueError(f"checkpoint holds {len(saved)} items where the template has {len(tmpl)}")
        return type(tmpl)(_load(t, s, gens, made) for t, s in zip(tmpl, saved))
    if isinstance(tmpl, dict):
        return {k: _load(v, saved[k], gens, made) for k, v in tmpl.items()}
    return saved


def save(path: str, runner: Any) -> None:
    """Saves a ``RunnerState`` to the file ``path`` (overwrites)."""
    gens: list = []
    tree = _dump(runner, gens, {})
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({"runner": tree, "generators": gens}, tmp)
    os.replace(tmp, path)


def _read(path: str) -> dict:
    return torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)


def restore(path: str, template: Any) -> Any:
    """Restores a ``RunnerState`` saved by :func:`save` into fresh objects
    shaped like ``template`` (e.g. a new ``PPO.init``), on its devices. The
    network is a copy of the template's; the template is not modified."""
    ckpt = _read(path)
    return _load(template, ckpt["runner"], ckpt["generators"], {})


def restore_params(path: str, network: nn.Module) -> nn.Module:
    """A copy of ``network`` holding ONLY the saved network's parameters:
    the warm start across run configs (``TrainConfig.init_from``). The
    architecture must match; everything else starts fresh."""
    state = _read(path)["runner"]["network"]["__module__"]
    net = copy.deepcopy(network)
    mine = net.state_dict()
    if set(mine) != set(state):
        raise ValueError("checkpoint params do not match the model: warm start needs the same network")
    for k, v in state.items():
        if tuple(v.shape) != tuple(mine[k].shape):
            raise ValueError(f"warm-start shape mismatch at {k}: checkpoint {tuple(v.shape)} vs model {tuple(mine[k].shape)}")
    net.load_state_dict(state)
    return net


def average_params(paths: list[str], network: nn.Module) -> nn.Module:
    """A copy of ``network`` with the element-wise mean of the parameters
    saved at ``paths`` (checkpoint averaging)."""
    if not paths:
        raise ValueError("average_params needs at least one checkpoint path")
    nets = [restore_params(p, network) for p in paths]
    out = copy.deepcopy(network)
    with torch.no_grad():
        for name, p in out.named_parameters():
            p.copy_(torch.stack([dict(n.named_parameters())[name] for n in nets]).mean(dim=0))
    return out


def best_model_name(idx: int, mean_len: float, std_len: float, mean_rew: float, std_rew: float) -> str:
    """The reference's best-model naming convention."""
    return f"best_model_{idx}_{mean_len:.0f}_{std_len:.0f}_{mean_rew:.0f}_{std_rew:.0f}"


LOG_STD_RANGE_KEY = "log_std_range"
# a VisionActorCritic's layout, which its parameters do not fix
VISION_KEYS = ("image_offset", "image_shape", "conv_features")


def save_policy_npz(path: str, network: nn.Module) -> None:
    """Writes ``network``'s parameters (its ``state_dict``, f32) to the
    ``.npz`` file ``path``, its ``log_std_range`` under one more key when
    the network has one, and a ``VisionActorCritic``'s ``VISION_KEYS``."""
    arrays = {k: v.detach().cpu().to(torch.float32).numpy() for k, v in network.state_dict().items()}
    if getattr(network, "log_std_range", None) is not None:
        arrays[LOG_STD_RANGE_KEY] = np.asarray(network.log_std_range, dtype=np.float32)
    if isinstance(network, VisionActorCritic):
        arrays.update({k: np.asarray(getattr(network, k), dtype=np.int64) for k in VISION_KEYS})
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def load_policy_npz(path: str, device: str | torch.device = "cuda") -> ActorCritic | VisionActorCritic:
    """The ``ActorCritic`` (or, where the file has ``VISION_KEYS``, the
    ``VisionActorCritic``) saved by ``save_policy_npz`` at ``path`` (or
    under that name in ``POLICY_DIR``), its widths read from the arrays and
    its ``log_std_range`` from the file where the file has one, on
    ``device``."""
    device = resolve_device(device)
    if not os.path.exists(path):
        path = os.path.join(POLICY_DIR, path if path.endswith(".npz") else f"{path}.npz")
    with np.load(path) as z:
        state = {k: torch.from_numpy(z[k].copy()) for k in z.files}
    log_std_range = state.pop(LOG_STD_RANGE_KEY, None)
    if log_std_range is not None:
        log_std_range = tuple(float(v) for v in log_std_range)
    vision = {k: state.pop(k).tolist() for k in VISION_KEYS if k in state}
    widths = lambda trunk: [state[f"{trunk}.layers.{i}.weight"].shape[0]  # noqa: E731
                            for i in range(sum(k.startswith(f"{trunk}.layers.") and k.endswith(".weight")
                                               for k in state))]
    pi_w, vf_w = widths("pi_trunk"), widths("vf_trunk")
    n_common = 0
    while n_common < min(len(pi_w), len(vf_w)) and pi_w[n_common] == vf_w[n_common]:
        n_common += 1
    feat_dim = state["pi_trunk.layers.0.weight"].shape[1] if pi_w else state["pi_head.weight"].shape[1]
    act_dim = state["pi_head.weight"].shape[0]
    sizes = dict(feature_sizes=pi_w[:n_common], pi_sizes=pi_w[n_common:], vf_sizes=vf_w[n_common:],
                 log_std_range=log_std_range, device="cpu")
    if vision:
        # the flat obs width: the image, and the trunks' input less the encoder's output
        shape, conv = vision["image_shape"], vision["conv_features"]
        net = VisionActorCritic(math.prod(shape) + feat_dim - encoded_size(shape, conv), act_dim,
                                vision["image_offset"], shape, conv_features=conv, **sizes)
    else:
        net = ActorCritic(feat_dim, act_dim, **sizes)
    net.load_state_dict(state)
    return net.to(device)
