"""The phased-consistency distillation steps: the epsilon / DDIM family
(SD1.5, SDXL) and the flow-matching family (SD3), the counterpart of
`pcm_tpu/train/distill.py`.

One step: the CFG teacher forward (cond and uncond batched into one pass)
and the stop-grad target forward under ``torch.no_grad``, the phased solver
jumps, then the student forward with gradients, the consistency loss, its
backward and the optimizer update. Gradient accumulation averages the
microbatches' (loss, grads) before one update.

The random draws come from outside: per microbatch ``{"noise", "index",
"w"}`` (with ``vae_noise``, the VAE posterior's, on a batch of pixels), and
for the adversarial steps (`train/adv.py`) also ``adv_offset`` (added to the
phase end to give the renoising timestep or grid point) and the renoising noises
``eps_fake`` and ``eps_real``. `sample_draws` makes them from a
``torch.Generator`` for the trainer; tests feed in the values JAX's
`ddim_prepare` and adversarial steps draw, so both packages run the same
step. With ``int8_no_grad_fwd`` (the CLI's ``--int8-matmul scoped``) the
teacher and target forwards run under ``int8_matmul("dense")`` and the
differentiated student keeps the dequantized weights. The flow step
(`build_flow_distill_step`) takes the same draws: its index picks a point of
the Euler solver's sigma grid, and ``w`` is the recipe's fixed guidance.

Both consistency steps' work falls into five spans (`utils/profiling.py`),
in order: ``teacher``, ``target``, ``student.forward``,
``student.backward`` and ``optimizer``; the host's waits on the card inside
them are ``wait.<site>`` spans.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..core.losses import cfg_combine, consistency_loss
from ..core.schedule import DDPMSchedule, FlowSchedule
from ..core.solver import PhasedDDIMSolver, PhasedEulerSolver, boundary_scalings, phase_boundaries
from ..parallel.mesh import all_reduce_mean, data_group
from ..utils import profiling
from ..utils.quant import int8_matmul
from .state import TrainState, apply_updates

Draws = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class DistillConfig:
    num_solver_steps: int = 50
    multiphase: int = 4
    w_min: float = 4.0
    w_max: float = 5.0
    fixed_w: Optional[float] = None  # SD3 uses fixed w=3
    not_apply_cfg_solver: bool = False
    loss_type: str = "huber"
    huber_c: float = 0.001
    # teacher + target forwards on the int8 "dense" path, the student on the
    # dequantized weights (`pcm_tpu/train/distill.py:49-68`)
    int8_no_grad_fwd: bool = False


def sample_draws(cfg: DistillConfig, generator: torch.Generator, latents: torch.Tensor,
                 adv_span: Optional[int] = None, posterior: bool = False) -> Draws:
    """One microbatch's draws on the latents' device: Gaussian noise shaped
    like the latents, solver indices in [0, S) and guidance scales w in
    [w_min, w_max) (or ``fixed_w``); for an adversarial step (``adv_span``)
    also renoising offsets in [0, adv_span) (`train/adv.py:adv_offset_span`:
    timesteps on DDIM, grid points on flow) and two more Gaussian noises
    shaped like the latents (`pcm_tpu/train/adv.py:167-172`); with
    ``posterior`` (a batch of pixels) last the VAE posterior's noise
    ``vae_noise``, shaped like the latents (`pcm_tpu/train/distill.py:143-144`).
    ``latents`` gives shape, dtype and device only (`SD15Bundle.latents_like`
    for pixels)."""
    bsz, dev = latents.shape[0], latents.device
    noise = torch.randn(latents.shape, generator=generator, device=dev, dtype=latents.dtype)
    index = torch.randint(0, cfg.num_solver_steps, (bsz,), generator=generator, device=dev)
    if cfg.fixed_w is not None:
        w = torch.full((bsz,), cfg.fixed_w, device=dev)
    else:
        w = torch.rand((bsz,), generator=generator, device=dev) * (cfg.w_max - cfg.w_min) + cfg.w_min
    draws = {"noise": noise, "index": index, "w": w}
    if adv_span is not None:
        draws["adv_offset"] = torch.randint(0, adv_span, (bsz,), generator=generator, device=dev)
        for k in ("eps_fake", "eps_real"):
            draws[k] = torch.randn(latents.shape, generator=generator, device=dev,
                                   dtype=latents.dtype)
    if posterior:
        draws["vae_noise"] = torch.randn(latents.shape, generator=generator, device=dev,
                                         dtype=latents.dtype)
    return draws


def split_microbatches(batch: Dict[str, torch.Tensor], accum: int) -> List[Dict[str, torch.Tensor]]:
    """Interleaved split: microbatch a holds rows a::accum (`accumulate_grads`)."""
    if accum <= 1:
        return [batch]
    for k, v in batch.items():
        if v.shape[0] % accum:
            raise ValueError(f"batch axis {v.shape[0]} of {k!r} not divisible by "
                             f"grad_accum_steps={accum}")
    return [{k: v[a::accum] for k, v in batch.items()} for a in range(accum)]


def tree_map(fn: Callable, *trees):
    """``fn`` over the tensors of nested dicts / tuples of the same structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def accumulate_grads(grad_fn: Callable, batch: Dict[str, torch.Tensor], draws: Sequence[Draws],
                     accum: int):
    """Mean of ``grad_fn(microbatch, draws[a])`` (a tree of tensors: the
    losses and grads) over the ``accum`` interleaved microbatches, summed in
    microbatch order; in a process group then averaged over the data group
    (`parallel/mesh.py:data_group`: the ranks with this rank's fsdp index,
    all of them without an FSDP layout; one all-reduce a step, JAX's psum
    over ``'data'``), so the losses and grads are the global batch's. The
    ranks of one fsdp group hold the same rows and reduce nothing between
    them: a ``data x fsdp`` run is then bit-equal to a ``data x 1`` one.
    The sums, the mean and the all-reduce are timed as the ``optimizer``
    span (`utils/profiling.py`)."""
    micro = split_microbatches(batch, accum)
    if len(draws) != len(micro):
        raise ValueError(f"{len(draws)} draws for {len(micro)} microbatches")
    total = None
    for mb, dr in zip(micro, draws):
        out = grad_fn(mb, dr)
        if total is None:
            total = out
        else:
            with profiling.span("optimizer"):
                total = tree_map(torch.add, total, out)
    with profiling.span("optimizer"):
        if accum > 1:
            total = tree_map(lambda t: t / accum, total)
        return all_reduce_mean(total, data_group())


def _merge_cond(cond, uncond):
    """cond and uncond batched into one, leaf by leaf (SDXL's nest too)."""
    if isinstance(cond, dict):
        return {k: _merge_cond(cond[k], uncond[k]) for k in cond}
    return torch.cat([cond, uncond], dim=0)


def _no_grad_fwd_ctx(cfg: DistillConfig):
    return int8_matmul("dense") if cfg.int8_no_grad_fwd else contextlib.nullcontext()


@torch.no_grad()
def ddim_prepare(bundle, schedule: DDPMSchedule, solver: PhasedDDIMSolver,
                 boundaries: torch.Tensor, cfg: DistillConfig, frozen, lora, batch,
                 draws: Draws) -> Dict[str, Any]:
    """Everything up to the stop-grad target: noising, the CFG teacher ODE
    step and the target network's jump (`ddim_prepare`, :137-184).
    ``lora`` is the student's current adapter."""
    with profiling.span("teacher"):
        latents, cond, uncond = bundle.encode(frozen, batch, draws.get("vae_noise"))
        noise, index, w = draws["noise"], draws["index"].long(), draws["w"]
        start_t = solver.table("timesteps", latents.device)[index]
        topk = schedule.num_train_timesteps // cfg.num_solver_steps
        t_prev = torch.clamp(start_t - topk, min=0)
        noisy = schedule.add_noise(latents, noise, start_t)

        with _no_grad_fwd_ctx(cfg):
            if cfg.not_apply_cfg_solver:
                cond_out = uncond_out = bundle.teacher(frozen, noisy, start_t, cond)
            else:
                both = bundle.teacher(frozen, torch.cat([noisy, noisy]),
                                      torch.cat([start_t, start_t]), _merge_cond(cond, uncond))
                cond_out, uncond_out = both.chunk(2)
        cond_x0 = schedule.predicted_origin(cond_out, start_t, noisy)
        uncond_x0 = schedule.predicted_origin(uncond_out, start_t, noisy)
        pred_x0 = cfg_combine(cond_x0, uncond_x0, w)
        pred_noise = cfg_combine(cond_out, uncond_out, w)
        x_prev = solver.ddim_step(pred_x0, pred_noise, index)

    with profiling.span("target"):
        with _no_grad_fwd_ctx(cfg):
            target_out = bundle.student(frozen, lora, x_prev, t_prev, cond)
        t_x0 = schedule.predicted_origin(target_out, t_prev, x_prev)
        target_jump, end_t = solver.multiphase_pred(t_x0, target_out, index, cfg.multiphase)
        c_skip, c_out = boundary_scalings(index, boundaries, latents.ndim)
        target = c_skip * x_prev + c_out * target_jump
    return dict(latents=latents, noise=noise, index=index, start_t=start_t, t_prev=t_prev,
                noisy=noisy, w=w, cond=cond, uncond=uncond, x_prev=x_prev, target=target,
                end_t=end_t)


def ddim_model_pred(bundle, schedule, solver, cfg, frozen, lora, parts) -> torch.Tensor:
    """The online student prediction, differentiable w.r.t. ``lora``
    (online boundary scalings are c_skip = 0, c_out = 1)."""
    noise_pred = bundle.student(frozen, lora, parts["noisy"], parts["start_t"], parts["cond"])
    px0 = schedule.predicted_origin(noise_pred, parts["start_t"], parts["noisy"])
    model_pred, _ = solver.multiphase_pred(px0, noise_pred, parts["index"], cfg.multiphase)
    return model_pred


def build_ddim_distill_step(bundle, schedule: DDPMSchedule, cfg: DistillConfig, tx,
                            grad_accum_steps: int = 1) -> Callable:
    """``step(state, frozen, batch, draws) -> (new_state, {"loss", "grad_norm"})``
    with ``draws`` one dict per microbatch. ``grad_norm`` is the global norm
    of the averaged grads before clipping."""
    solver = PhasedDDIMSolver.create(schedule, cfg.num_solver_steps)
    bounds = phase_boundaries(cfg.num_solver_steps, cfg.multiphase)

    def step(state: TrainState, frozen, batch, draws: Sequence[Draws]
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        device = next(iter(state.params.values())).device
        with profiling.span("teacher"), profiling.span("wait.step_boundaries"):
            boundaries = torch.from_numpy(bounds).to(device)

        def grad_fn(mb, dr):
            parts = ddim_prepare(bundle, schedule, solver, boundaries, cfg, frozen,
                                 state.params, mb, dr)
            return student_grads(
                lambda lora: ddim_model_pred(bundle, schedule, solver, cfg, frozen, lora, parts),
                parts["target"], state.params, cfg)

        loss, grads = accumulate_grads(grad_fn, batch, draws, grad_accum_steps)
        return optimizer_step(state, loss, grads, tx)

    return step


def student_grads(model_pred: Callable, target: torch.Tensor, params, cfg: DistillConfig):
    """The student's phases of a consistency step: ``student.forward`` (the
    prediction ``model_pred(lora)`` through the loss against ``target``),
    then ``student.backward``; returns the loss and the grads by leaf."""
    with torch.enable_grad():
        with profiling.span("student.forward"):
            lora = {k: p.detach().requires_grad_(True) for k, p in params.items()}
            loss = consistency_loss(model_pred(lora), target, cfg.loss_type, cfg.huber_c)
        with profiling.span("student.backward"):
            grads = torch.autograd.grad(loss, list(lora.values()))
    return loss.detach(), dict(zip(lora, grads))


def optimizer_step(state: TrainState, loss: torch.Tensor, grads, tx
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """The update and the step's metrics, in the ``optimizer`` span."""
    with profiling.span("optimizer"):
        new_state = apply_updates(state, grads, tx)
        return new_state, {"loss": loss, "grad_norm": new_state.grad_norm}


# ---------------------------------------------------------------------------
# flow-matching family (SD3), `pcm_tpu/train/distill.py:229-305`
# ---------------------------------------------------------------------------


@torch.no_grad()
def flow_prepare(bundle, schedule: FlowSchedule, solver: PhasedEulerSolver, cfg: DistillConfig,
                 frozen, lora, batch, draws: Draws) -> Dict[str, Any]:
    """Everything up to the stop-grad target: noising at the grid point's
    sigma, the CFG teacher's Euler step and the target network's jump from
    the step's end (``is_target``). ``lora`` is the student's current adapter."""
    with profiling.span("teacher"):
        latents, cond, uncond = bundle.encode(frozen, batch, draws.get("vae_noise"))
        noise, index, w = draws["noise"], draws["index"].long(), draws["w"]
        sigmas = solver.table("sigmas", latents.device)[index]
        sigmas_prev = solver.table("sigmas_prev", latents.device)[index]
        timesteps = sigmas * schedule.num_train_timesteps
        timesteps_prev = sigmas_prev * schedule.num_train_timesteps
        noisy = schedule.add_noise(latents, noise, sigmas)

        with _no_grad_fwd_ctx(cfg):
            if cfg.not_apply_cfg_solver:
                cond_out = uncond_out = bundle.teacher(frozen, noisy, timesteps, cond)
            else:
                both = bundle.teacher(frozen, torch.cat([noisy, noisy]),
                                      torch.cat([timesteps, timesteps]),
                                      _merge_cond(cond, uncond))
                cond_out, uncond_out = both.chunk(2)
        teacher_v = cfg_combine(cond_out, uncond_out, w)
        x_prev = solver.euler_step(noisy, teacher_v, index)

    with profiling.span("target"):
        with _no_grad_fwd_ctx(cfg):
            target_out = bundle.student(frozen, lora, x_prev, timesteps_prev, cond)
        target, end_index = solver.multiphase_pred(x_prev, target_out, index, cfg.multiphase,
                                                   is_target=True)
    return dict(latents=latents, noise=noise, index=index, timesteps=timesteps,
                timesteps_prev=timesteps_prev, noisy=noisy, w=w, cond=cond, uncond=uncond,
                x_prev=x_prev, target=target, end_index=end_index)


def flow_model_pred(bundle, schedule, solver, cfg, frozen, lora, parts) -> torch.Tensor:
    """The online student's jump to its phase start, differentiable w.r.t. ``lora``."""
    v_pred = bundle.student(frozen, lora, parts["noisy"], parts["timesteps"], parts["cond"])
    model_pred, _ = solver.multiphase_pred(parts["noisy"], v_pred, parts["index"], cfg.multiphase)
    return model_pred


def build_flow_distill_step(bundle, schedule: FlowSchedule, cfg: DistillConfig, tx,
                            grad_accum_steps: int = 1) -> Callable:
    """The flow-matching (SD3) consistency step, called as the DDIM one
    (`build_ddim_distill_step`)."""
    solver = PhasedEulerSolver.create(schedule, cfg.num_solver_steps)

    def step(state: TrainState, frozen, batch, draws: Sequence[Draws]
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        def grad_fn(mb, dr):
            parts = flow_prepare(bundle, schedule, solver, cfg, frozen, state.params, mb, dr)
            return student_grads(
                lambda lora: flow_model_pred(bundle, schedule, solver, cfg, frozen, lora, parts),
                parts["target"], state.params, cfg)

        loss, grads = accumulate_grads(grad_fn, batch, draws, grad_accum_steps)
        return optimizer_step(state, loss, grads, tx)

    return step
