"""kl-f8 VAE finetuning: reconstruction, KL, perceptual and GAN losses.

The JAX package's ``VAEFinetuneTrainer`` (``slice3d_tpu/train/
train_vae.py:50-272``; reference ``AutoencoderKL`` with
``LPIPSWithDiscriminator``, autoencoder.py:442-451, contperceptual.py).  Each
step the autoencoder's Adam minimises ``nll + kl_weight * KL + d_weight *
gan_on * (-D(rec))`` and the discriminator's Adam the hinge loss times
``gan_on``, where ``gan_on`` is ``disc_factor`` from step ``disc_start`` on
and 0 before.  Both optimizers are ``optax.adam``'s (b1 0.5, b2 0.9, eps
1e-8), and both gradients are taken from the state before the step.

* The NLL: with LPIPS weights ``sum(|x - rec| + w * lpips) / B`` (pixel
  summed, the reference's with ``logvar`` 0); without, ``mean|x - rec|``.
  The JAX trainer's VGG19 fallback term (``vgg19_params``) has no
  counterpart: no CLI passes VGG19 weights to it.
* The adaptive weight: the norms of the NLL's and the generator loss's
  gradients at ``decoder.conv_out.weight``, taken from the step's one
  forward, ``clamp(nll_gn / (g_gn + 1e-4), 0, 1e4) * disc_weight``,
  detached as in the reference.  It is computed and logged while the GAN
  is off too.
* The discriminator, as the JAX package runs it: the generator's pass
  reads the running statistics and leaves them (the reference runs it on
  batch statistics); the D loss runs ``x`` and then ``rec.detach()`` on
  batch statistics, two batches, and keeps the statistics that ``x``'s pass
  left.  D runs, and its statistics move, while the GAN is off; its zero
  gradient then leaves its parameters in place under Adam.  The generator
  loss's gradient reaches no D parameter and the D loss's no VAE parameter.

Differences from the JAX package, on purpose: the adaptive weight is
detached (the JAX step differentiates through it, which adds a
second-order term to the VAE's gradient once the GAN is on).  The state is
updated in place.  Checkpoints take the JAX trainer's ``ckpt_backend``
values (``train/checkpoint.py``): a ``torch.save`` file, or a
``torch.distributed.checkpoint`` directory that every process of a group
writes together; ``restore`` reads both and the JAX trainer's checkpoints,
msgpack files and orbax directories (``convert.vae_train_payload``).

The networks compute in ``dtype`` over fp32 master weights (so gradients
and Adam's moments are fp32); the losses are fp32.  The posterior sample's
noise comes from the caller's ``torch.Generator`` or ``draws``.

In a process group (one process a card) the step is data-parallel and
equals the one-process step on the global batch: the posterior noise is the
rank's rows of the global batch's (handed, or drawn at the global size from
the shared generator), D's BatchNorms take the global statistics, the two
gradients of the adaptive weight are averaged over the group before their
norms, both optimizers' gradients are averaged before their steps and the
logs are the group's means.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import torch

from .. import resolve_device
from ..convert import vae_state_dict, vae_train_payload
from ..models.discriminator import (NLayerDiscriminator, adaptive_disc_weight, generator_loss,
                                    hinge_d_loss, patchgan_logits_size)
from ..models.layers import BatchNorm2d
from ..models.lpips import load_lpips
from ..models.random_init import random_init_
from ..models.vae import AutoencoderKL, DiagonalGaussian
from ..parallel import (all_reduce_average, all_reduce_gradients, all_reduce_mean, data_size,
                        in_group, rank_part)
from .checkpoint import (adam_payload, check_backend, is_checkpoint_dir, is_torch_file,
                         load_adam_payload, optimizer_shards, restore_checkpoint,
                         save_checkpoint)
from .flax_msgpack import read_flax_checkpoint

__all__ = ["VAETrainState", "VAEFinetuneTrainer", "default_disc_layers", "vae_weights"]


@dataclass
class VAETrainState:
    """The VAE, the discriminator (with its BatchNorm statistics), their two
    Adams, and the number of steps taken."""

    vae: AutoencoderKL
    disc: NLayerDiscriminator
    optimizer: torch.optim.Adam
    disc_optimizer: torch.optim.Adam
    step: int = 0


def default_disc_layers(img_size: int) -> int:
    """The PatchGAN depth for ``img_size``: 3, shrunk until the logits are
    not empty (below ~30 px the standard depth collapses)."""
    n = 3
    while n > 1 and patchgan_logits_size(img_size, n) < 1:
        n -= 1
    return n


def vae_weights(path: str) -> Dict[str, torch.Tensor]:
    """The VAE's ``state_dict`` from a finetune checkpoint: the port's file or
    directory (``"vae"``) or the JAX trainer's, a msgpack file or an orbax
    directory (``params``)."""
    if is_checkpoint_dir(path):
        return restore_checkpoint(path, keys=("vae",))["vae"]
    if not os.path.isdir(path) and is_torch_file(path):
        return restore_checkpoint(path)["vae"]
    return vae_state_dict(read_flax_checkpoint(path)["params"])


def _adam(params, lr: float) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=lr, betas=(0.5, 0.9), eps=1e-8)


class VAEFinetuneTrainer:
    """Finetune an ``AutoencoderKL`` on batches of ``image`` (N, H, W, 3) in
    [-1, 1] against an ``NLayerDiscriminator``.

    ``lpips_params``: a taming LPIPS ``state_dict`` (the NLL's perceptual
    term, frozen).  ``disc_n_layers`` None: :func:`default_disc_layers`.
    ``ckpt_backend``: ``save``'s format (``train/checkpoint.py``'s BACKENDS).
    Runs on CUDA unless ``device`` says otherwise."""

    def __init__(self, *, img_size: int = 128, lr: float = 4.5e-6, kl_weight: float = 1e-6,
                 perceptual_weight: float = 1.0, disc_start: int = 50001,
                 disc_factor: float = 1.0, disc_weight: float = 0.5,
                 disc_n_layers: Optional[int] = None, vae_ch: int = 128,
                 vae_mult: Sequence[int] = (1, 2, 4, 4), vae_nres: int = 2,
                 lpips_params: Optional[Mapping[str, torch.Tensor]] = None,
                 dtype: torch.dtype = torch.float32,
                 device: Optional[Union[str, torch.device]] = None,
                 ckpt_backend: str = "msgpack"):
        self.device = resolve_device(device)
        self.ckpt_backend = check_backend(ckpt_backend)
        if disc_n_layers is None:
            disc_n_layers = default_disc_layers(img_size)
        if patchgan_logits_size(img_size, disc_n_layers) < 1:
            raise ValueError(f"img_size={img_size} too small for a {disc_n_layers}-layer "
                             "PatchGAN (empty logits)")
        self.disc_n_layers = disc_n_layers
        self.img_size = img_size
        self.lr = lr
        self.kl_weight = kl_weight
        self.perceptual_weight = perceptual_weight
        self.disc_start = disc_start
        self.disc_factor = disc_factor
        self.disc_weight = disc_weight
        self.vae_widths = dict(ch=vae_ch, ch_mult=tuple(vae_mult), num_res_blocks=vae_nres)
        self.dtype = dtype
        self.lpips = (None if lpips_params is None
                      else load_lpips(lpips_params).to(self.device))

    # -- state ------------------------------------------------------------------

    def init_state(self, seed: int = 0) -> VAETrainState:
        """A VAE and a discriminator drawn from ``seed`` (the discriminator's
        running statistics at 0 / 1) on the trainer's device, each with its
        Adam."""
        g = torch.Generator().manual_seed(seed)
        cd = None if self.dtype == torch.float32 else self.dtype
        vae = random_init_(AutoencoderKL(dtype=cd, **self.vae_widths), g)
        disc = random_init_(NLayerDiscriminator(n_layers=self.disc_n_layers, dtype=cd), g)
        for mod in disc.modules():
            if isinstance(mod, BatchNorm2d):
                mod.reset_running_stats()
        vae, disc = vae.to(self.device), disc.to(self.device)
        return VAETrainState(vae=vae, disc=disc, optimizer=_adam(vae.parameters(), self.lr),
                             disc_optimizer=_adam(disc.parameters(), self.lr))

    # -- steps --------------------------------------------------------------------

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x).to(self.device, torch.float32)

    def _reconstruct(self, vae: AutoencoderKL, x: torch.Tensor, noise,
                     generator: Optional[torch.Generator]):
        """(rec, moments) in fp32, the posterior noise from ``noise`` or
        ``generator``: in a group its data index's rows of the global
        batch's."""
        if in_group():
            n, hw = x.shape[0], x.shape[1] // vae.downscale
            if noise is None:
                noise = torch.randn((data_size() * n, hw, hw, vae.post_quant_conv.in_channels),
                                    generator=generator, device=self.device)
            noise = rank_part(self._tensor(noise), n)
        rec, moments = vae(x, None if noise is None else self._tensor(noise), generator)
        return rec.float(), moments.float()

    def _lpips(self, x: torch.Tensor, rec: torch.Tensor) -> torch.Tensor:
        return self.lpips(x.to(self.dtype), rec.to(self.dtype))

    def _nll(self, x: torch.Tensor, rec: torch.Tensor) -> torch.Tensor:
        if self.lpips is not None and self.perceptual_weight > 0:
            p = self._lpips(x, rec)
            return torch.sum(torch.abs(rec - x) + self.perceptual_weight * p[:, None, None, None]
                             ) / x.shape[0]
        return torch.mean(torch.abs(rec - x))

    def train_step(self, state: VAETrainState, batch: Mapping[str, Any],
                   generator: Optional[torch.Generator] = None, *,
                   draws: Optional[Mapping[str, Any]] = None
                   ) -> Tuple[VAETrainState, Dict[str, torch.Tensor]]:
        """One step of both optimizers (in place).  ``draws`` may hold
        ``posterior_noise`` (N, h, w, z); else it comes from ``generator``.
        Each parameter's ``.grad`` keeps the applied gradient until the next
        step.  Returns (state, logs as 0-d tensors: ``rec_loss``, ``kl``,
        ``g_loss``, ``d_weight``, ``ae_loss``, ``disc_loss``)."""
        x = self._tensor(batch["image"])
        gan_on = float(state.step >= self.disc_start) * self.disc_factor
        vae, disc = state.vae, state.disc
        rec, moments = self._reconstruct(vae, x, (draws or {}).get("posterior_noise"),
                                         generator)
        nll = self._nll(x, rec)
        kl = torch.mean(DiagonalGaussian(moments).kl())
        disc.requires_grad_(False)  # the generator loss reaches rec, not D
        g = generator_loss(disc(rec, train=False).float())
        disc.requires_grad_(True)
        last = vae.decoder.conv_out.weight
        nll_grad, = torch.autograd.grad(nll, last, retain_graph=True)
        g_grad, = torch.autograd.grad(g, last, retain_graph=True)
        all_reduce_average([nll_grad, g_grad])  # the global batch's, as the weight's
        d_weight = adaptive_disc_weight(torch.linalg.vector_norm(nll_grad),
                                        torch.linalg.vector_norm(g_grad), self.disc_weight)
        ae_loss = nll + self.kl_weight * kl + d_weight * gan_on * g
        state.optimizer.zero_grad(set_to_none=True)
        ae_loss.backward()

        state.disc_optimizer.zero_grad(set_to_none=True)
        logits_real = disc(x, train=True)
        kept = {k: v.clone() for k, v in disc.named_buffers()}
        logits_fake = disc(rec.detach(), train=True)
        with torch.no_grad():  # the statistics of x's pass stay, as in the JAX step
            for k, v in disc.named_buffers():
                v.copy_(kept[k])
        d_loss = gan_on * hinge_d_loss(logits_real.float(), logits_fake.float())
        d_loss.backward()

        for opt in (state.optimizer, state.disc_optimizer):
            for group in opt.param_groups:
                for p in group["params"]:
                    if p.grad is None:  # optax sees a zero gradient there
                        p.grad = torch.zeros_like(p)
            all_reduce_gradients(p for group in opt.param_groups for p in group["params"])
            opt.step()
        state.step += 1
        logs = {"rec_loss": nll, "kl": kl, "g_loss": g, "d_weight": d_weight,
                "ae_loss": ae_loss, "disc_loss": d_loss}
        return state, all_reduce_mean({k: v.detach() for k, v in logs.items()})

    # -- evaluation ---------------------------------------------------------------

    @torch.no_grad()
    def eval_loss(self, state: VAETrainState, batch: Mapping[str, Any],
                  generator: Optional[torch.Generator] = None, *,
                  draws: Optional[Mapping[str, Any]] = None) -> Dict[str, float]:
        """Validation logs: ``rec_loss`` (mean |x - rec|), ``kl``, and
        ``lpips`` (the batch's mean distance) with LPIPS weights."""
        x = self._tensor(batch["image"])
        rec, moments = self._reconstruct(state.vae, x, (draws or {}).get("posterior_noise"),
                                         generator)
        logs = {"rec_loss": torch.mean(torch.abs(rec - x)),
                "kl": torch.mean(DiagonalGaussian(moments).kl())}
        if self.lpips is not None and self.perceptual_weight > 0:
            logs["lpips"] = torch.mean(self._lpips(x, rec))
        return {k: float(v) for k, v in logs.items()}

    @torch.no_grad()
    def reconstruct(self, state: VAETrainState, images, *,
                    generator: Optional[torch.Generator] = None,
                    noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(N, H, W, 3) -> the VAE's reconstructions from a posterior sample,
        fp32."""
        return self._reconstruct(state.vae, self._tensor(images), noise, generator)[0]

    # -- checkpoints ------------------------------------------------------------------

    def state_payload(self, state: VAETrainState) -> Dict[str, Any]:
        """A ``msgpack`` file's tensors: both networks' ``state_dict``, both
        Adams' moments by parameter name with their counts, the step."""
        return {"vae": state.vae.state_dict(), "disc": state.disc.state_dict(),
                "adam": adam_payload(state.optimizer, state.vae),
                "disc_adam": adam_payload(state.disc_optimizer, state.disc),
                "step": state.step}

    def shard_payload(self, state: VAETrainState) -> Dict[str, Any]:
        """A directory's tensors as they lie (``optimizer_shards``: both Adams'
        state by parameter name), so a restore through it loads in place."""
        return {"vae": state.vae.state_dict(), "disc": state.disc.state_dict(),
                "adam": optimizer_shards(state.optimizer, dict(state.vae.named_parameters())),
                "disc_adam": optimizer_shards(state.disc_optimizer,
                                              dict(state.disc.named_parameters())),
                "step": state.step}

    def checkpoint_payload(self, state: VAETrainState) -> Dict[str, Any]:
        """What ``save`` writes in the trainer's ``ckpt_backend``."""
        if self.ckpt_backend == "msgpack":
            return self.state_payload(state)
        return self.shard_payload(state)

    def load_payload(self, state: VAETrainState, payload: Mapping[str, Any]) -> VAETrainState:
        """In place: both networks' weights (and D's statistics), both Adams'
        moments and counts, the step."""
        state.vae.load_state_dict(payload["vae"])
        state.disc.load_state_dict(payload["disc"])
        load_adam_payload(state.optimizer, state.vae, payload["adam"])
        load_adam_payload(state.disc_optimizer, state.disc, payload["disc_adam"])
        state.step = int(payload["step"])
        return state

    def save(self, state: VAETrainState, path: str) -> str:
        """Write ``checkpoint_payload`` at ``path`` in ``ckpt_backend``'s format
        (a directory: every process of the group together)."""
        return save_checkpoint(path, self.checkpoint_payload(state), self.ckpt_backend)

    def restore(self, state: VAETrainState, path: str) -> VAETrainState:
        """In place, from the port's checkpoint (a file, or a directory read
        into ``shard_payload``'s tensors) or the JAX trainer's, a msgpack
        file or an orbax directory."""
        if is_checkpoint_dir(path):
            state.step = int(restore_checkpoint(path, target=self.shard_payload(state))["step"])
            return state
        if not os.path.isdir(path) and is_torch_file(path):
            return self.load_payload(state, restore_checkpoint(path, map_location=self.device))
        return self.load_payload(state, vae_train_payload(read_flax_checkpoint(path)))
