"""Adversarial consistency training: discriminator heads over the frozen
teacher's features, hinge losses, the alternating D/G steps and the fused
pair, for the epsilon / DDIM family (SD1.5, SDXL) and the flow family (SD3)
(counterpart of `pcm_tpu/train/adv.py`).

The discriminator is the frozen teacher run for its feature taps
(`models/unet.py`, `models/mmdit.py`) plus small trainable conv heads,
computed in fp32 (their convolutions in TF32 on the card: `heads_precision`):
SD1.5 taps all nine levels with four 3x3 heads a tap, SDXL the down levels
and the mid block with one 1x1 head each (so its teacher stops after the mid
block), SD3 the image stream after each of its 24 joint blocks, as a 64x64
grid at 1024 px, with one 1x1 head each. A head's GroupNorm runs K4 on fp32
tensors on the card.

Two pairings of the D and G updates, as the JAX package has them:

- `build_ddim_adv_steps` / `build_flow_adv_steps`: ``(g_step, d_step)``,
  each on its own batch; the trainer's step alternates them by global-step
  parity (D on even steps).
- `build_ddim_adv_fused_pair` / `build_flow_adv_fused_pair`: one batch feeds
  one D and one G update from one prepare and one student forward;
  `build_adv_train_step` wraps either pairing of either family as the
  trainer's one step. No gradient crosses between the players: the LoRA
  gradients are `torch.autograd.grad` of ``cm + w g`` with respect to the
  LoRA factors alone, with the heads' current parameters taken as
  constants, and the heads' gradients come from the D loss on detached
  fake features, as JAX's ``stop_gradient`` walls give.

The two families differ only in the prepare and the online prediction
(`distill.py`) and in the renoising: DDIM travels to the timestep
``min(end_t + offset, T - 1)``; flow renoises on the Euler grid, at grid
point ``end_index + offset`` and the float timestep ``1000 sigma`` there.
The draws (``noise``, ``index``, ``w``, ``adv_offset``, ``eps_fake``,
``eps_real``) come from outside, one dict a microbatch (`distill.sample_draws`,
``adv_offset`` in [0, `adv_offset_span`)). The heads' parameters are a flat
dict named ``head_{i}_{j}.{conv1, norm1, conv2, norm2, conv_out}.{weight,
bias}``; `Discriminator` is a module built on the meta device that takes
them per call (`Discriminator.logits`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.losses import consistency_loss, feature_matching_loss, hinge_d_loss, hinge_g_loss
from ..core.schedule import DDPMSchedule, FlowSchedule, bcast
from ..core.solver import PhasedDDIMSolver, PhasedEulerSolver, phase_boundaries
from ..models.normalization import GroupNorm
from ..utils import profiling
from .distill import (Draws, DistillConfig, _merge_cond, accumulate_grads, ddim_model_pred,
                      ddim_prepare, flow_model_pred, flow_prepare)
from .state import TrainState, apply_updates

Features = Dict[str, torch.Tensor]
Params = Dict[str, torch.Tensor]


class DiscriminatorHead(nn.Module):
    """conv -> GroupNorm(32) -> LeakyReLU(0.01), twice, with a residual, then a
    1x1 conv to one logit map (`pcm_tpu/train/adv.py:41-59`); NCHW."""

    def __init__(self, channels: int, kernel: int):
        super().__init__()
        pad = kernel // 2  # "SAME" at stride 1 for the odd kernels used
        self.conv1 = nn.Conv2d(channels, channels, kernel, padding=pad)
        self.norm1 = GroupNorm(32, channels)
        self.conv2 = nn.Conv2d(channels, channels, kernel, padding=pad)
        self.norm2 = GroupNorm(32, channels)
        self.conv_out = nn.Conv2d(channels, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.leaky_relu(self.norm1(self.conv1(x)), 0.01)
        h2 = F.leaky_relu(self.norm2(self.conv2(h)), 0.01)
        return self.conv_out(h2 + h)


@dataclasses.dataclass(frozen=True)
class DiscriminatorConfig:
    taps: Tuple[str, ...]  # feature keys of the teacher's taps, in head order
    num_h_per_head: int = 1
    kernel: int = 1


SD15_DISC_CONFIG = DiscriminatorConfig(
    taps=("down_0", "down_1", "down_2", "down_3", "mid", "up_0", "up_1", "up_2", "up_3"),
    num_h_per_head=4, kernel=3)
SDXL_DISC_CONFIG = DiscriminatorConfig(taps=("down_0", "down_1", "down_2", "mid"))
SD3_DISC_CONFIG = DiscriminatorConfig(taps=tuple(f"block_{i}" for i in range(24)))


def _to_grid(f: torch.Tensor) -> torch.Tensor:
    """A tap in the JAX layout, (B, H, W, C) or seq (B, S, C) with S a square,
    as the NCHW view the heads take (channels-last memory: no copy)."""
    if f.ndim == 3:
        b, s, c = f.shape
        side = int(round(s ** 0.5))
        f = f.reshape(b, side, side, c)
    return f.permute(0, 3, 1, 2)


class Discriminator(nn.Module):
    """Heads over the taps of ``cfg``: ``num_h_per_head`` heads a tap, named
    ``head_{tap index}_{j}``. ``forward(features)`` takes the taps in the
    JAX layout, computes in fp32 and returns one (B, h, w, 1) logit map a
    head."""

    def __init__(self, cfg: DiscriminatorConfig, tap_channels: Dict[str, int]):
        super().__init__()
        self.cfg = cfg
        for i, tap in enumerate(cfg.taps):
            for j in range(cfg.num_h_per_head):
                self.add_module(f"head_{i}_{j}", DiscriminatorHead(tap_channels[tap], cfg.kernel))

    @property
    def stop_after_mid(self) -> bool:
        """No tap past the mid block: the teacher's up blocks need not run."""
        return not any(t.startswith("up") for t in self.cfg.taps)

    def forward(self, features: Features) -> List[torch.Tensor]:
        outputs = []
        for i, tap in enumerate(self.cfg.taps):
            x = _to_grid(features[tap].float())
            for j in range(self.cfg.num_h_per_head):
                outputs.append(getattr(self, f"head_{i}_{j}")(x).permute(0, 2, 3, 1))
        return outputs

    def logits(self, params: Params, features: Features) -> List[torch.Tensor]:
        """The logits with the heads' parameters ``params`` (differentiable
        in them where they require grad)."""
        return torch.func.functional_call(self, params, (features,), strict=True)


def init_discriminator(cfg: DiscriminatorConfig, tap_channels: Dict[str, int],
                       generator: torch.Generator, device: torch.device
                       ) -> Tuple[Discriminator, Params]:
    """The heads (a meta-device module) and their fp32 parameters drawn as
    flax initializes them: conv kernels lecun-normal (a normal truncated at
    two standard deviations, scaled to variance 1 / fan_in), conv biases
    zero, GroupNorm scale one and bias zero."""
    with torch.device("meta"):
        disc = Discriminator(cfg, tap_channels)
    params = {}
    for name, p in disc.named_parameters():
        if name.endswith("bias"):
            t = torch.zeros(p.shape, device=device)
        elif ".norm" in name:
            t = torch.ones(p.shape, device=device)
        else:
            t = torch.empty(p.shape, device=device)
            torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
            # 0.879...: the standard deviation of a unit normal truncated to (-2, 2)
            t.mul_(math.sqrt(1.0 / p[0].numel()) / 0.87962566103423978)
        params[name] = t
    return disc, params


def feature_match_loss(fake_feats: Features, real_feats: Features) -> torch.Tensor:
    """Mean-squared feature matching over the taps (sorted by name), the real
    branch detached (`pcm_tpu/train/adv.py:feature_match_loss`)."""
    taps = sorted(fake_feats)
    return feature_matching_loss([fake_feats[k] for k in taps],
                                 [real_feats[k].detach() for k in taps])


@dataclasses.dataclass(frozen=True)
class AdvConfig:
    adv_weight: float = 0.1


def pair_features(bundle, frozen, fake: torch.Tensor, real: torch.Tensor,
                  adv_t: torch.Tensor, cond, stop_after_mid: bool = False
                  ) -> Tuple[Features, Features]:
    """The teacher's taps of ``fake`` and ``real`` from one 2B feature forward
    (`pcm_tpu/train/adv.py:131-146`): every op is per sample, so they equal
    two B passes."""
    bsz = fake.shape[0]
    feats = bundle.teacher_features(frozen, torch.cat([fake, real]), torch.cat([adv_t, adv_t]),
                                    _merge_cond(cond, cond), stop_after_mid)
    return ({k: f[:bsz] for k, f in feats.items()}, {k: f[bsz:] for k, f in feats.items()})


def _leaves(params: Params) -> Params:
    return {k: p.detach().requires_grad_(True) for k, p in params.items()}


def heads_precision() -> None:
    """The heads' fp32 convolutions multiply in TF32 and accumulate in fp32
    (cuDNN's default), set here for the process. The JAX heads run their
    fp32 convolutions at XLA's default precision, which on the TPU multiplies
    in one bf16 pass; TF32 keeps three more bits of each mantissa. The flag
    is read when a convolution runs, its backward too, so it is set when a
    step is built and not around the heads' call. It touches no bf16
    convolution: the UNets' are all bf16 on the card."""
    torch.backends.cudnn.allow_tf32 = True


def _flow_renoise(x, eps, sig_end, sig_adv):
    """Flow-space renoising from sigma ``sig_end`` to ``sig_adv``
    (`pcm_tpu/train/adv.py:405-407`)."""
    return ((1.0 - sig_adv) * x + (sig_adv - sig_end) * eps) / (1.0 - sig_end)


@dataclasses.dataclass(frozen=True)
class _Family:
    """What the adversarial steps take from a family: ``prepare(frozen,
    lora, batch, draws) -> parts`` (no grad), ``model_pred(frozen, lora,
    parts)`` (the online prediction, differentiable in ``lora``) and
    ``renoise(parts, draws) -> (fn(x, eps), adv_t)``."""
    prepare: Callable
    model_pred: Callable
    renoise: Callable


def _ddim_family(bundle, schedule: DDPMSchedule, cfg: DistillConfig) -> _Family:
    solver = PhasedDDIMSolver.create(schedule, cfg.num_solver_steps)
    bounds = phase_boundaries(cfg.num_solver_steps, cfg.multiphase)

    def prepare(frozen, lora, mb, dr):
        with profiling.span("wait.adv_boundaries"):  # a pageable copy: the host waits
            boundaries = torch.from_numpy(bounds).to(dr["index"].device)
        return ddim_prepare(bundle, schedule, solver, boundaries, cfg, frozen, lora, mb, dr)

    def renoise(parts, dr):
        end_t = parts["end_t"]
        adv_t = torch.clamp(end_t + dr["adv_offset"].long(), max=schedule.num_train_timesteps - 1)
        return (lambda x, eps: schedule.noise_travel(x, eps, end_t, adv_t)), adv_t

    return _Family(prepare, lambda frozen, lora, parts: ddim_model_pred(
        bundle, schedule, solver, cfg, frozen, lora, parts), renoise)


def _flow_family(bundle, schedule: FlowSchedule, cfg: DistillConfig) -> _Family:
    solver = PhasedEulerSolver.create(schedule, cfg.num_solver_steps)

    def renoise(parts, dr):
        end = parts["end_index"]
        sig = solver.table("sigmas_prev", end.device)
        adv_index = end + dr["adv_offset"].long()
        ndim = parts["latents"].ndim
        sig_end, sig_adv = bcast(sig[end], ndim), bcast(sig[adv_index], ndim)
        return ((lambda x, eps: _flow_renoise(x, eps, sig_end, sig_adv)),
                sig[adv_index] * schedule.num_train_timesteps)

    return _Family(
        lambda frozen, lora, mb, dr: flow_prepare(bundle, schedule, solver, cfg, frozen, lora,
                                                  mb, dr),
        lambda frozen, lora, parts: flow_model_pred(bundle, schedule, solver, cfg, frozen, lora,
                                                    parts),
        renoise)


def adv_offset_span(schedule, cfg: DistillConfig) -> int:
    """The renoising offset's range [0, span): timesteps on DDIM, ``T //
    multiphase``; Euler grid points on flow, ``num_solver_steps //
    multiphase`` (`pcm_tpu/train/adv.py:470-474`), so that ``end_index +
    offset`` stays on the grid."""
    if isinstance(schedule, FlowSchedule):
        return cfg.num_solver_steps // cfg.multiphase
    return schedule.num_train_timesteps // cfg.multiphase


def _family(bundle, schedule, cfg: DistillConfig) -> _Family:
    return (_flow_family if isinstance(schedule, FlowSchedule) else _ddim_family)(
        bundle, schedule, cfg)


def _adv_steps(bundle, fam: _Family, cfg: DistillConfig, adv: AdvConfig, disc: Discriminator,
               tx_g, tx_d, grad_accum_steps: int) -> Tuple[Callable, Callable]:
    heads_precision()
    stop = disc.stop_after_mid

    def g_step(g_state: TrainState, d_state: TrainState, frozen, batch, draws: Sequence[Draws]):
        def grad_fn(mb, dr):
            parts = fam.prepare(frozen, g_state.params, mb, dr)
            renoise, adv_t = fam.renoise(parts, dr)
            lora = _leaves(g_state.params)
            with torch.enable_grad():
                model_pred = fam.model_pred(frozen, lora, parts)
                cm = consistency_loss(model_pred, parts["target"], cfg.loss_type, cfg.huber_c)
                fake = renoise(model_pred, dr["eps_fake"])
                feats = bundle.teacher_features(frozen, fake, adv_t, parts["cond"], stop)
                g = hinge_g_loss(disc.logits(d_state.params, feats))
                loss = cm + adv.adv_weight * g
                grads = torch.autograd.grad(loss, list(lora.values()))
            return (loss.detach(), cm.detach(), g.detach()), dict(zip(lora, grads))

        (loss, cm, g), grads = accumulate_grads(grad_fn, batch, draws, grad_accum_steps)
        new = apply_updates(g_state, grads, tx_g)
        return new, {"loss": loss, "loss_cm": cm, "g_loss": g, "grad_norm": new.grad_norm}

    def d_step(g_state: TrainState, d_state: TrainState, frozen, batch, draws: Sequence[Draws]):
        def grad_fn(mb, dr):
            parts = fam.prepare(frozen, g_state.params, mb, dr)
            renoise, adv_t = fam.renoise(parts, dr)
            with torch.no_grad():
                model_pred = fam.model_pred(frozen, g_state.params, parts)
                fake = renoise(model_pred, dr["eps_fake"])
                real = renoise(parts["target"], dr["eps_real"])
                fake_feats, real_feats = pair_features(bundle, frozen, fake, real, adv_t,
                                                       parts["cond"], stop)
            dp = _leaves(d_state.params)
            with torch.enable_grad():
                loss = hinge_d_loss(disc.logits(dp, fake_feats), disc.logits(dp, real_feats))
                grads = torch.autograd.grad(loss, list(dp.values()))
            return loss.detach(), dict(zip(dp, grads))

        loss, grads = accumulate_grads(grad_fn, batch, draws, grad_accum_steps)
        new = apply_updates(d_state, grads, tx_d)
        return new, {"d_loss": loss, "d_grad_norm": new.grad_norm}

    return g_step, d_step


def _adv_fused_pair(bundle, fam: _Family, cfg: DistillConfig, adv: AdvConfig,
                    disc: Discriminator, tx_g, tx_d, grad_accum_steps: int) -> Callable:
    heads_precision()
    stop = disc.stop_after_mid

    def pair_step(g_state: TrainState, d_state: TrainState, frozen, batch,
                  draws: Sequence[Draws]):
        def grad_fn(mb, dr):
            parts = fam.prepare(frozen, g_state.params, mb, dr)
            renoise, adv_t = fam.renoise(parts, dr)
            with torch.no_grad():  # the real branch carries no gradient for either player
                real = renoise(parts["target"], dr["eps_real"])
                real_feats = bundle.teacher_features(frozen, real, adv_t, parts["cond"], stop)
            lora, dp = _leaves(g_state.params), _leaves(d_state.params)
            with torch.enable_grad():
                model_pred = fam.model_pred(frozen, lora, parts)
                cm = consistency_loss(model_pred, parts["target"], cfg.loss_type, cfg.huber_c)
                fake = renoise(model_pred, dr["eps_fake"])
                fake_feats = bundle.teacher_features(frozen, fake, adv_t, parts["cond"], stop)
                # the heads' parameters as constants: the G loss reaches the LoRA only
                g = hinge_g_loss(disc.logits(d_state.params, fake_feats))
                g_grads = torch.autograd.grad(cm + adv.adv_weight * g, list(lora.values()))
                # detached fake features: the D loss reaches the heads only
                d = hinge_d_loss(disc.logits(dp, {k: f.detach() for k, f in fake_feats.items()}),
                                 disc.logits(dp, real_feats))
                d_grads = torch.autograd.grad(d, list(dp.values()))
            return ((cm.detach(), g.detach(), d.detach()),
                    (dict(zip(lora, g_grads)), dict(zip(dp, d_grads))))

        (cm, g, d), (g_grads, d_grads) = accumulate_grads(grad_fn, batch, draws,
                                                          grad_accum_steps)
        g_new = apply_updates(g_state, g_grads, tx_g)
        d_new = apply_updates(d_state, d_grads, tx_d)
        metrics = {"loss": cm + adv.adv_weight * g, "loss_cm": cm, "g_loss": g, "d_loss": d,
                   "grad_norm": g_new.grad_norm, "d_grad_norm": d_new.grad_norm}
        return g_new, d_new, metrics

    return pair_step


def build_ddim_adv_steps(bundle, schedule: DDPMSchedule, cfg: DistillConfig, adv: AdvConfig,
                         disc: Discriminator, tx_g, tx_d, grad_accum_steps: int = 1
                         ) -> Tuple[Callable, Callable]:
    """``(g_step, d_step)``, each ``(g_state, d_state, frozen, batch, draws)``:
    ``g_step`` returns the new LoRA state and {loss, loss_cm, g_loss,
    grad_norm}, ``d_step`` the new heads' state and {d_loss, d_grad_norm}."""
    return _adv_steps(bundle, _ddim_family(bundle, schedule, cfg), cfg, adv, disc, tx_g, tx_d,
                      grad_accum_steps)


def build_ddim_adv_fused_pair(bundle, schedule: DDPMSchedule, cfg: DistillConfig,
                              adv: AdvConfig, disc: Discriminator, tx_g, tx_d,
                              grad_accum_steps: int = 1) -> Callable:
    """``pair_step(g_state, d_state, frozen, batch, draws) -> (new_g, new_d,
    metrics)``: one D and one G update from one batch, both from the
    pre-update parameters (`pcm_tpu/train/adv.py:240-336`)."""
    return _adv_fused_pair(bundle, _ddim_family(bundle, schedule, cfg), cfg, adv, disc, tx_g,
                           tx_d, grad_accum_steps)


def build_flow_adv_steps(bundle, schedule: FlowSchedule, cfg: DistillConfig, adv: AdvConfig,
                         disc: Discriminator, tx_g, tx_d, grad_accum_steps: int = 1
                         ) -> Tuple[Callable, Callable]:
    """The flow family's (SD3) ``(g_step, d_step)``, called as the DDIM
    ones (`pcm_tpu/train/adv.py:459-537`)."""
    return _adv_steps(bundle, _flow_family(bundle, schedule, cfg), cfg, adv, disc, tx_g, tx_d,
                      grad_accum_steps)


def build_flow_adv_fused_pair(bundle, schedule: FlowSchedule, cfg: DistillConfig,
                              adv: AdvConfig, disc: Discriminator, tx_g, tx_d,
                              grad_accum_steps: int = 1) -> Callable:
    """The flow family's fused pair, called as the DDIM one
    (`pcm_tpu/train/adv.py:540-607`)."""
    return _adv_fused_pair(bundle, _flow_family(bundle, schedule, cfg), cfg, adv, disc, tx_g,
                           tx_d, grad_accum_steps)


def build_adv_train_step(bundle, schedule, cfg: DistillConfig, adv: AdvConfig,
                         disc: Discriminator, tx_g, tx_d, pairing: str,
                         grad_accum_steps: int = 1) -> Callable:
    """The trainer's step for either family (by ``schedule``: a
    `FlowSchedule` takes the flow steps), ``step(g_state, d_state, frozen,
    batch, draws, global_step) -> (g_state, d_state, metrics, global steps
    counted)``: with ``fresh`` a D update on an even global step and a G
    update on an odd one, each counting one; with ``fused`` a pair counting
    two (`pcm_tpu/train/loop.py:359-372`)."""
    fam = _family(bundle, schedule, cfg)
    parts = (bundle, fam, cfg, adv, disc, tx_g, tx_d, grad_accum_steps)
    if pairing == "fused":
        pair_step = _adv_fused_pair(*parts)

        def step(g_state, d_state, frozen, batch, draws, global_step):
            return (*pair_step(g_state, d_state, frozen, batch, draws), 2)
    elif pairing == "fresh":
        g_step, d_step = _adv_steps(*parts)

        def step(g_state, d_state, frozen, batch, draws, global_step):
            if global_step % 2 == 0:
                d_state, metrics = d_step(g_state, d_state, frozen, batch, draws)
            else:
                g_state, metrics = g_step(g_state, d_state, frozen, batch, draws)
            return g_state, d_state, metrics, 1
    else:
        raise ValueError(f"pairing {pairing!r}: fresh or fused")
    return step
