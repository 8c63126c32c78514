"""LDM training: the generation route's denoiser and conditioner learn the slices.

The JAX package's ``LDMTrainer`` (``slice3d_tpu/train/train_ldm.py:54-301,
537-569``; reference ddpm.py:343-365, 571-586, 971-983, 1420-1442).  Per
step the frozen kl-f8 VAE encodes the 13 images (12 slices and the input
view) with no gradient, the 12 slice latents tile into the scaled atlas, the
VGG16-BN conditioner encodes the input view with its BatchNorms on batch
statistics, and the UNet learns eps-prediction under L1 (``p_losses``).
AdamW (optax's defaults: b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-4)
updates the UNet and the conditioner, and ``logvar`` when it is learned; an
EMA of the same parameters (not the BatchNorm statistics) follows each
update.  ``scale_by_std`` sets the latents' scale factor to 1/std from the
first batch.  The LR is ``accumulate * n * bs * base_lr`` over n processes
of ``bs`` each (``scale_lr``; the JAX package's n is its device count),
times the ``scheduler_config`` multiplier.

In a process group (one process a card) the step is data-parallel and
equals the one-process step on the global batch: each process's draws are
its data index's rows of the global batch's (a handed draw is global, a
missing one is drawn at the global size from the shared generator), the
conditioner's BatchNorms take the global statistics, the gradients are
averaged over the group before AdamW, the logs are the group's means and
``scale_by_std`` takes the global batch's std (over the data group).  On a
process mesh with a ``model`` axis larger than 1
(``parallel.init_process_mesh``) the model's
parameters of at least ``fsdp_min_size`` elements are sharded over it
(``parallel.shard_params_fsdp``, the frozen VAE's too, as the JAX dry run
shards the whole state), AdamW's moments and the EMA take their layout,
and the processes of one model group take the same rows and draws.  A ``msgpack``
checkpoint gathers the shards on every process, so it is the unsharded
one's; a directory checkpoint (``ckpt_backend`` ``orbax`` / ``orbax_async``,
``train/checkpoint.py``) is written by every process, each its own shards,
and restores into a state sharded over any model axis, or none.

Differences from the JAX package, on purpose:

* ``logvar`` stays fixed unless ``learn_logvar``: the JAX trainer masks it
  out of AdamW with ``optax.masked``, which passes the raw gradient through
  for masked leaves, so there ``logvar`` moves by its gradient every step.
  The reference keeps it fixed (ddpm.py:1420-1429).
* The state is updated in place (parameters, optimizer, EMA, BatchNorm
  statistics): the JAX package returns a new state each step.
* The conditioner's last BatchNorm (``conv_last.0``, after the fifth tap)
  feeds no output and does not run, so its running statistics stay where
  they are; the JAX backbone runs it and moves them.

Networks compute in the module's dtype (bf16 on the card) from fp32 master
weights, so the gradients, AdamW's state and the EMA are fp32.  Each step's
random draws (posterior noise, then t, then the noise) come from the
caller's ``torch.Generator`` or are handed in (``draws``), so a test can
replay the JAX package's.

Sampling (``sample_slices`` with any sampler and guidance,
``sample_progressive``) runs under the EMA weights; ``diffusion_row`` and
``reconstruct_slices`` (the VAE round trip of ``main --mode rec``) read the
frozen VAE only (``train_ldm.py:305-535``).  ``restore`` reads the port's
own checkpoints (files and directories) and the JAX trainer's ones, msgpack
files and orbax directories (``save``: variables, EMA, ``scale_factor``, ``logvar``, step), whose
optimizer state it leaves out: AdamW starts fresh.
"""

from __future__ import annotations

import contextlib
import copy
import os
import zipfile
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import torch

from .. import resolve_device
import numpy as np

from ..convert import ldm_train_payload
from ..diffusion.ancestral import ddpm_sample
from ..diffusion.latent import LatentDiffusion, init_latent_diffusion, p_losses
from ..diffusion.sampler import atlas_shape, encode_condition, make_eps_fn, sample_slices
from ..diffusion.schedule import DiffusionSchedule
from ..models.ema import ema_update
from ..parallel import (all_reduce_gradients, all_reduce_mean, all_reduce_sum, data_size,
                        full_state_dict, full_tensor, in_group, load_state_dict_sharded,
                        optimizer_groups, process_mesh, rank_part, shard_like,
                        shard_params_fsdp)
from .checkpoint import (check_backend, is_checkpoint_dir, load_optimizer_payload,
                         optimizer_payload, optimizer_shards, restore_checkpoint,
                         save_checkpoint)
from .flax_msgpack import read_flax_checkpoint
from .lr_schedules import from_scheduler_config

__all__ = ["LDMTrainState", "LDMTrainer", "TRAINABLE_PREFIXES"]

# the trained subtrees: the UNet and the conditioner (the VAE is frozen)
TRAINABLE_PREFIXES = ("model.", "cond_stage_model.")
WEIGHT_DECAY = 1e-4  # optax.adamw's default, which the JAX package runs (torch's is 0.01)


@dataclass
class LDMTrainState:
    """What a training run carries: the model (weights, BatchNorm statistics
    and ``scale_factor``), AdamW, the EMA of the trainable parameters (fp32,
    by name), the (T,) ``logvar`` and the number of micro-steps taken."""

    ldm: LatentDiffusion
    optimizer: torch.optim.AdamW
    ema: Dict[str, torch.Tensor]
    logvar: torch.Tensor
    step: int = 0


def trainable_parameters(ldm: LatentDiffusion) -> Dict[str, torch.nn.Parameter]:
    """The UNet's and the conditioner's parameters, by name."""
    return {n: p for n, p in ldm.named_parameters() if n.startswith(TRAINABLE_PREFIXES)}


class LDMTrainer:
    """Train a ``LatentDiffusion`` on batches of ``image`` (B, 13, H, W, 3) and
    ``img_ipt_view`` (B, H, W, 3) in [-1, 1].

    ``module``: the model to train (copied by :meth:`init_state`); without
    it :meth:`init_state` draws one with ``init_latent_diffusion`` at the
    128 px operating point.  ``batch_size`` is a process's; the current
    process mesh's model axis (``parallel.process_mesh()``) shards the
    parameters of at least ``fsdp_min_size`` elements.  ``ckpt_backend``:
    ``save``'s format (``train/checkpoint.py``'s BACKENDS).  Runs on CUDA
    unless ``device`` says otherwise.
    """

    def __init__(self, *, img_size: int = 128, batch_size: int = 8, base_lr: float = 5e-5,
                 scale_lr: bool = True, timesteps: int = 1000, linear_start: float = 0.0015,
                 linear_end: float = 0.0155, loss_type: str = "l1", use_ema: bool = True,
                 scale_by_std: bool = True, accumulate: int = 1,
                 module: Optional[LatentDiffusion] = None,
                 scheduler_config: Optional[Dict[str, Any]] = None,
                 learn_logvar: bool = False, cond_train_bn: bool = True,
                 device: Optional[Union[str, torch.device]] = None,
                 fsdp_min_size: int = 2 ** 16, ckpt_backend: str = "msgpack"):
        self.device = resolve_device(device)
        self.fsdp_min_size = fsdp_min_size
        self.ckpt_backend = check_backend(ckpt_backend)
        self.module = module
        self.img_size = img_size
        self.batch_size = batch_size
        self.timesteps = timesteps
        self.linear_start = linear_start
        self.linear_end = linear_end
        self.schedule = DiffusionSchedule.create(timesteps, "linear", linear_start, linear_end)
        self.loss_type = loss_type
        self.use_ema = use_ema
        self.scale_by_std = scale_by_std
        self.accumulate = int(accumulate)
        self.learn_logvar = learn_logvar
        self.cond_train_bn = cond_train_bn
        # accumulate * batch shards * bs * base_lr
        self.lr = accumulate * data_size() * batch_size * base_lr if scale_lr else base_lr
        self.lr_multiplier = from_scheduler_config(scheduler_config)

    # -- state ------------------------------------------------------------------

    def init_state(self, seed: int = 0) -> LDMTrainState:
        """A fresh state on the trainer's device: a copy of ``module`` (or a
        model drawn from ``seed``), the VAE frozen, the parameters sharded
        over the mesh's model axis, AdamW over the trainable parameters (and
        ``logvar`` when learned; the shards in a group of their own), the EMA
        a copy of them, ``logvar`` zero."""
        if self.module is not None:
            ldm = copy.deepcopy(self.module)
        else:
            ldm = init_latent_diffusion(seed, timesteps=self.timesteps,
                                        linear_start=self.linear_start,
                                        linear_end=self.linear_end,
                                        latent_size=self.img_size // 8)
        ldm = ldm.to(self.device).eval()
        ldm.first_stage_model.requires_grad_(False)
        shard_params_fsdp(ldm, process_mesh(), self.fsdp_min_size)
        params = trainable_parameters(ldm)
        logvar = torch.zeros(self.timesteps, dtype=torch.float32, device=self.device)
        if self.learn_logvar:
            logvar = torch.nn.Parameter(logvar)
        group = list(params.values()) + ([logvar] if self.learn_logvar else [])
        optimizer = torch.optim.AdamW(optimizer_groups(group), lr=self.lr, betas=(0.9, 0.999),
                                      eps=1e-8, weight_decay=WEIGHT_DECAY)
        ema = ({n: p.detach().to(torch.float32).clone() for n, p in params.items()}
               if self.use_ema else {})
        return LDMTrainState(ldm=ldm, optimizer=optimizer, ema=ema, logvar=logvar)

    def current_lr(self, update: int) -> float:
        """The LR of optimizer update number ``update`` (0-based)."""
        if self.lr_multiplier is None:
            return float(self.lr)
        return float(self.lr * self.lr_multiplier(update))

    # -- batches and draws -------------------------------------------------------

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32).to(self.device)

    def _encode(self, state: LDMTrainState, images: torch.Tensor,
                noise: Optional[torch.Tensor], generator: Optional[torch.Generator]
                ) -> torch.Tensor:
        with torch.no_grad():
            return state.ldm.encode_images(
                images, noise=None if noise is None else self._tensor(noise),
                generator=generator)

    def _encode_slices(self, state: LDMTrainState, images, generator, posterior_noise
                       ) -> torch.Tensor:
        """The first 12 tiles of ``images`` (B, 12 or 13, H, W, 3) encoded, with
        the posterior noise's first 12 tiles when it is given."""
        return self._encode(state, self._tensor(images)[:, :12],
                            None if posterior_noise is None else posterior_noise[:, :12],
                            generator)

    def _posterior_noise(self, ldm: LatentDiffusion, images, generator,
                         noise: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """This process's posterior noise (B, K, h, w, z) for ``images``: in a
        group its data index's rows of the global batch's, ``noise`` if handed
        (it is global), else drawn at the global size from ``generator`` in
        the draw order of the one-process step; without a group ``noise`` as
        it is."""
        if not in_group():
            return noise
        b, k, hh, ww, _ = images.shape
        f, n = ldm.downscale, data_size()
        zc = ldm.first_stage_model.post_quant_conv.in_channels
        if noise is None:
            noise = torch.randn((n * b * k, hh // f, ww // f, zc),
                                generator=generator, device=self.device)
        return rank_part(self._tensor(noise).reshape(n * b, k, hh // f, ww // f, zc), b)

    def _step_draws(self, ldm: LatentDiffusion, images, generator,
                    draws: Optional[Mapping[str, Any]]) -> Dict[str, Any]:
        """A step's draws for this process (see ``_posterior_noise``): the
        posterior noise, then t (B,), then the noise (the atlas's shape)."""
        draws = dict(draws or {})
        if not in_group():
            return draws
        n, b, k, hh, ww, _ = data_size(), *images.shape
        f = ldm.downscale
        zc = ldm.first_stage_model.post_quant_conv.in_channels
        out = {"posterior_noise": self._posterior_noise(ldm, images, generator,
                                                        draws.get("posterior_noise"))}
        t = draws.get("t")
        if t is None:
            t = torch.randint(0, self.schedule.num_timesteps, (n * b,), generator=generator,
                              device=self.device)
        out["t"] = rank_part(torch.as_tensor(t).to(self.device), b)
        noise = draws.get("noise")
        if noise is None:
            noise = torch.randn((n * b, 4 * (hh // f), 4 * (ww // f), zc), generator=generator,
                                device=self.device)
        out["noise"] = rank_part(self._tensor(noise), b)
        return out

    def maybe_set_scale(self, state: LDMTrainState, batch: Mapping[str, Any],
                        generator: Optional[torch.Generator] = None, *,
                        noise: Optional[torch.Tensor] = None) -> LDMTrainState:
        """Before the first step with ``scale_by_std``: ``scale_factor`` =
        1 / std of the batch's sampled latents (biased std, as ``jnp.std``;
        the global batch's in a group); the posterior noise from
        ``generator`` or ``noise`` (B, 13, h, w, 4; the global batch's in a
        group)."""
        if not self.scale_by_std or state.step > 0:
            return state
        images = self._tensor(batch["image"])
        z = self._encode(state, images,
                         self._posterior_noise(state.ldm, images, generator, noise), generator)
        if not in_group():
            std = z.std(correction=0)
        else:
            zd = z.double()
            sums = all_reduce_sum(torch.stack([zd.sum(), (zd * zd).sum(),
                                               torch.tensor(float(z.numel()), device=z.device,
                                                            dtype=torch.float64)]))
            mean = sums[0] / sums[2]
            std = torch.sqrt(sums[1] / sums[2] - mean * mean).to(z.dtype)
        scale = 1.0 / std
        state.ldm.scale_factor.copy_(scale)
        print(f"### USING STD-RESCALING: scale_factor = {float(scale):.6f} ###")
        return state

    def _loss(self, state: LDMTrainState, batch: Mapping[str, Any], *, cond_train: bool,
              generator: Optional[torch.Generator], draws: Optional[Mapping[str, Any]]):
        ldm = state.ldm
        images = self._tensor(batch["image"])
        draws = self._step_draws(ldm, images, generator, draws)
        z13 = self._encode(state, images, draws.get("posterior_noise"), generator)
        cond = ldm.build_cond(z13, self._tensor(batch["img_ipt_view"]), train=cond_train)
        t, noise = draws.get("t"), draws.get("noise")
        return p_losses(ldm, self.schedule, ldm.make_atlas(z13), cond, logvar=state.logvar,
                        loss_type=self.loss_type,
                        t=None if t is None else torch.as_tensor(t).to(self.device),
                        noise=None if noise is None else self._tensor(noise),
                        generator=generator)

    # -- steps --------------------------------------------------------------------

    def loss_and_grads(self, state: LDMTrainState, batch: Mapping[str, Any],
                       generator: Optional[torch.Generator] = None, *,
                       draws: Optional[Mapping[str, Any]] = None) -> Dict[str, torch.Tensor]:
        """One micro-step's forward and backward: adds the loss's gradient over
        ``accumulate`` to each trainable parameter's ``.grad`` (and runs the
        conditioner's BatchNorms in train mode when ``cond_train_bn``, which
        moves their running statistics).  ``draws`` may hold
        ``posterior_noise`` (B, 13, h, w, 4), ``t`` (B,) and ``noise`` (the
        atlas's shape); what it lacks comes from ``generator``.  In a group
        the draws are the global batch's and the logs the group's means.
        Returns the logs (0-d tensors)."""
        loss, logs = self._loss(state, batch, cond_train=self.cond_train_bn,
                                generator=generator, draws=draws)
        (loss / self.accumulate).backward()
        return all_reduce_mean({k: v.detach() for k, v in logs.items()})

    def train_step(self, state: LDMTrainState, batch: Mapping[str, Any],
                   generator: Optional[torch.Generator] = None, *,
                   draws: Optional[Mapping[str, Any]] = None):
        """One micro-step (in place): gradients accumulate over ``accumulate``
        micro-steps and AdamW applies their mean on the last, which also
        moves the EMA (warm-up step: the number of updates before this one).
        Each parameter's ``.grad`` keeps the applied gradient until the next
        step.  Returns (state, logs)."""
        if state.step % self.accumulate == 0:
            state.optimizer.zero_grad(set_to_none=True)
        logs = self.loss_and_grads(state, batch, generator, draws=draws)
        state.step += 1
        if state.step % self.accumulate == 0:
            update = state.step // self.accumulate - 1
            for group in state.optimizer.param_groups:
                group["lr"] = self.current_lr(update)
                # a parameter the loss does not reach (a VGG block past the
                # last tap) still decays, as under optax, which sees a zero
                # gradient where torch's AdamW would skip a missing one
                for p in group["params"]:
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
            all_reduce_gradients(p for group in state.optimizer.param_groups
                                 for p in group["params"])
            state.optimizer.step()
            if self.use_ema:
                ema_update(state.ema, trainable_parameters(state.ldm), update)
        return state, logs

    # -- evaluation and sampling ----------------------------------------------------

    @contextlib.contextmanager
    def ema_weights(self, state: LDMTrainState, use_ema: bool = True):
        """Within the block the trainable parameters hold the EMA (when
        ``use_ema`` and the trainer keeps one); they are put back after."""
        if not (use_ema and self.use_ema):
            yield state.ldm
            return
        params = trainable_parameters(state.ldm)
        saved = {n: p.detach().clone() for n, p in params.items()}
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(state.ema[n])
        try:
            yield state.ldm
        finally:
            with torch.no_grad():
                for n, p in params.items():
                    p.copy_(saved[n])

    @torch.no_grad()
    def eval_loss(self, state: LDMTrainState, batch: Mapping[str, Any],
                  generator: Optional[torch.Generator] = None, *,
                  draws: Optional[Mapping[str, Any]] = None,
                  use_ema: bool = True) -> Dict[str, float]:
        """Validation losses with the running BatchNorm statistics; with
        ``use_ema`` the EMA weights are evaluated (the reference logs both).
        In a group: this process's shard, its draws as the step's."""
        with self.ema_weights(state, use_ema):
            _, logs = self._loss(state, batch, cond_train=False, generator=generator,
                                 draws=draws)
        return {k: float(v) for k, v in logs.items()}

    def sample_slices(self, state: LDMTrainState, img_input, *, use_ema: bool = True,
                      **kwargs) -> torch.Tensor:
        """Input views (B, H, W, 3) -> generated slices (B, 12, H, W, 3) through
        :func:`slice3d_tpu_torch.diffusion.sampler.sample_slices` (its keyword
        arguments), with the EMA weights when ``use_ema``."""
        with self.ema_weights(state, use_ema):
            return sample_slices(state.ldm, self._tensor(img_input), device=self.device,
                                 **kwargs)

    @torch.no_grad()
    def sample_progressive(self, state: LDMTrainState, img_input, *, log_every_t: int = 200,
                           generator: Optional[torch.Generator] = None, use_ema: bool = True,
                           temperature: float = 1.0,
                           posterior_noise: Optional[torch.Tensor] = None,
                           x_T: Optional[torch.Tensor] = None,
                           step_noises: Optional[Sequence[torch.Tensor]] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full-T progressive denoising (reference ddpm.py:1213-1268, the
        ``plot_progressive_rows`` of ``log_images``): the ancestral chain with
        the running x0 estimate recorded every ``log_every_t`` steps, each
        row decoded.  Draws as ``sample_slices`` (posterior noise of the input
        view, x_T, one noise per step).  Returns (final slices (B, 12, H, W,
        3), rows (n_log, B, 12, H, W, 3)) in [-1, 1], fp32."""
        with self.ema_weights(state, use_ema):
            ldm = state.ldm
            img = self._tensor(img_input)
            cond = encode_condition(ldm, img, generator, posterior_noise)
            atlas, rows = ddpm_sample(make_eps_fn(ldm, cond), self.schedule,
                                      atlas_shape(ldm, img), generator=generator,
                                      device=self.device, x_T=x_T, noises=step_noises,
                                      log_every_t=log_every_t, record="pred_x0",
                                      temperature=temperature)
            final = ldm.decode_atlas_images(atlas, keep=12).float()
            return final, torch.stack([ldm.decode_atlas_images(r, keep=12).float()
                                       for r in rows])

    @torch.no_grad()
    def diffusion_row(self, state: LDMTrainState, images, *, log_every_t: int = 200,
                      generator: Optional[torch.Generator] = None,
                      posterior_noise: Optional[torch.Tensor] = None,
                      noises: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """Forward-noising rows (the ``plot_diffusion_rows`` of reference
        ``log_images``, ddpm.py:1370-1385): the clean atlas of ``images``
        (B, 12 or 13, H, W, 3; the first 12 are the slices) noised to each
        logged t (``t % log_every_t == 0 or t == T - 1``) and decoded.  The
        posterior noise (B, 12, h, w, 4) and one noise per logged t come from
        ``generator`` unless given.  Returns (n_log, B, 12, H, W, 3) fp32."""
        ldm = state.ldm
        atlas0 = ldm.make_atlas(self._encode_slices(state, images, generator, posterior_noise))
        t_total = self.schedule.num_timesteps
        steps = [t for t in range(t_total) if t % log_every_t == 0 or t == t_total - 1]
        if noises is not None and len(noises) != len(steps):
            raise ValueError(f"need {len(steps)} noises, got {len(noises)}")
        rows = []
        for i, t in enumerate(steps):
            noise = (self._tensor(noises[i]) if noises is not None else torch.randn(
                atlas0.shape, generator=generator, device=self.device))
            z_noisy = (float(self.schedule.sqrt_alphas_cumprod[t]) * atlas0
                       + float(self.schedule.sqrt_one_minus_alphas_cumprod[t]) * noise)
            rows.append(ldm.decode_atlas_images(z_noisy, keep=12).float())
        return torch.stack(rows)

    @torch.no_grad()
    def reconstruct_slices(self, state: LDMTrainState, images, *,
                           generator: Optional[torch.Generator] = None,
                           posterior_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The VAE round trip of the slices (``main --mode rec``): ``images``
        (B, 12 or 13, H, W, 3), the first 12 encoded (a posterior sample,
        noise (B, 12, h, w, 4) from ``generator`` unless given) and decoded.
        Returns (B, 12, H, W, 3) fp32 in [-1, 1]."""
        z12 = self._encode_slices(state, images, generator, posterior_noise)
        return state.ldm.decode_tiles(z12).float()

    # -- checkpoints ------------------------------------------------------------------

    def _optimized(self, state: LDMTrainState) -> Dict[str, torch.Tensor]:
        """AdamW's parameters by name, in the order of an unsharded state's one
        group."""
        params: Dict[str, torch.Tensor] = dict(trainable_parameters(state.ldm))
        if self.learn_logvar:
            params["logvar"] = state.logvar
        return params

    def state_payload(self, state: LDMTrainState) -> Dict[str, Any]:
        """The checkpoint's tensors, shards gathered (a ``msgpack`` file): every
        process of a model group calls it."""
        return {"model": full_state_dict(state.ldm),
                "optimizer": optimizer_payload(state.optimizer,
                                               list(self._optimized(state).values())),
                "ema": {n: full_tensor(e) for n, e in state.ema.items()},
                "logvar": state.logvar.detach(), "step": state.step}

    def shard_payload(self, state: LDMTrainState) -> Dict[str, Any]:
        """The checkpoint's tensors as they lie (a directory): the model's
        ``state_dict`` and the EMA (a sharded parameter's shards), AdamW's
        state by parameter name (``optimizer_shards``), ``logvar`` and the
        step; nothing gathered or copied, so a restore through it loads the
        state in place."""
        return {"model": state.ldm.state_dict(),
                "optimizer": optimizer_shards(state.optimizer, self._optimized(state)),
                "ema": state.ema, "logvar": state.logvar.detach(), "step": state.step}

    def checkpoint_payload(self, state: LDMTrainState) -> Dict[str, Any]:
        """What ``save`` writes in the trainer's ``ckpt_backend``:
        ``state_payload`` for ``msgpack``, else ``shard_payload``."""
        if self.ckpt_backend == "msgpack":
            return self.state_payload(state)
        return self.shard_payload(state)

    def load_payload(self, state: LDMTrainState, payload: Mapping[str, Any]) -> LDMTrainState:
        """In place: the model's weights and statistics, the EMA, ``logvar``,
        the step and (when the payload has it) AdamW's state; a sharded state
        takes its part of an unsharded payload."""
        load_state_dict_sharded(state.ldm, payload["model"])
        if "optimizer" in payload:
            load_optimizer_payload(state.optimizer, list(self._optimized(state).values()),
                                   payload["optimizer"])
        with torch.no_grad():
            for n, e in state.ema.items():
                e.copy_(shard_like(e, payload["ema"][n]))
            state.logvar.copy_(payload["logvar"])
        state.step = int(payload["step"])
        return state

    def save(self, state: LDMTrainState, path: str) -> str:
        """Write ``checkpoint_payload`` at ``path`` in ``ckpt_backend``'s
        format.  A ``msgpack`` file of a sharded state is written by one
        process while every other runs ``state_payload`` (the gather); a
        directory is written by every process of the group together."""
        return save_checkpoint(path, self.checkpoint_payload(state), self.ckpt_backend)

    def restore(self, state: LDMTrainState, path: str) -> LDMTrainState:
        """In place, from the port's checkpoint (a ``torch.save`` file, or a
        directory read into ``shard_payload``'s tensors: each process its own
        shards, however the state is sharded) or the JAX trainer's, a msgpack
        file or an orbax directory (its variables, EMA, ``scale_factor``,
        ``logvar`` and step; AdamW starts fresh)."""
        if is_checkpoint_dir(path):
            payload = restore_checkpoint(path, target=self.shard_payload(state))
            state.step = int(payload["step"])
            return state
        if os.path.isdir(path) or not zipfile.is_zipfile(path):
            tree = read_flax_checkpoint(path)
            variables = tree["variables"]
            params = variables["params"]
            # a run without EMA saved none: the weights are their own average
            ema = tree["ema_params"] or {k: params[k] for k in ("model", "cond_stage")}
            payload = ldm_train_payload(params, variables["batch_stats"], ema, tree["logvar"],
                                        float(np.asarray(tree["scale_factor"])),
                                        int(np.asarray(tree["step"])))
            return self.load_payload(state, payload)
        return self.load_payload(state, restore_checkpoint(path, map_location=self.device))
