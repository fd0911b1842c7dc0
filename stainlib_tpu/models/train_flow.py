"""Distributed residual-flow + GMM trainer.

JAX counterpart of ``dlmodels/color-information/train_img_horo.py``:
the Horovod/NCCL machinery (hvd.init, DistributedOptimizer with Adasum,
param broadcast, allreduce/allgather — ``:148-189,406-454,742-748,877``)
becomes a mesh + shard_map data-parallel step with ``psum``ed gradients;
the training niceties carry over one-to-one:

* linear LR warmup (``update_lr``, ``:255-259``),
* gradient accumulation every ``update_freq`` steps + grad-norm clip 1.0
  (``:577-594``) via ``optax.MultiSteps`` + ``clip_by_global_norm``,
* EMA after each update (``:366,594``),
* ``update_lipschitz`` after each optimizer step (``:1089-1095``),
* keep-last-5 + most-recent checkpointing and resume (``:421-448,
  1149-1165``) via :mod:`stainlib_tpu.utils.checkpoint`,
* template-statistic allreduce at validation (``:742-748``) — free under
  SPMD (the stats are computed on replicated outputs).

The model consumes HSD images: the flow sees the density channel D, the GMM
conditions on the chroma (cx, cy) — the ``compute_loss`` wiring of
``train_img_horo.py:466-501``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import jax
import jax.numpy as jnp
import optax
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from stainlib_tpu.models.gmm import ConvGMM, bits_per_dim
from stainlib_tpu.models.resflow import ResidualFlow, update_lipschitz
from stainlib_tpu.utils.ema import EmaState, ema_init, ema_update


@dataclasses.dataclass
class FlowConfig:
    """The argparse surface of ``train_img_horo.py:43-141``, reduced to the
    knobs that affect the math."""

    image_size: int = 32
    n_scales: int = 2
    blocks_per_scale: int = 4
    hidden: int = 64
    coeff: float = 0.98
    n_power_series: int = 6
    n_clusters: int = 4
    lr: float = 1e-3
    warmup_iters: int = 1000
    cosine_restart_period: int = 0  # >0: CosineAnnealingWarmRestarts parity
    update_freq: int = 1  # gradient accumulation factor
    grad_clip: float = 1.0
    ema_decay: float = 0.999
    nvals: int = 256
    remat: bool = False  # rematerialize the flow forward in the backward pass
    kernel_sizes: tuple = (3, 3, 3)  # the reference's --kernels (3-1-3 pub.)
    remat_logdet: bool = False  # checkpoint each power-series term's jvp


def reference_capacity() -> "FlowConfig":
    """The published-model configuration: ~500k parameters on 256x256
    patches (``color-information/README.md`` segmentation table reports
    500,388 params; ctor ``train_img_horo.py:324-358`` with the default
    ``--idim 128 --kernels 3-1-3``). This config lands at 502,855 params
    (flow 491,835 + ConvGMM 11,020): 3 scales x 5 iResBlocks, hidden 128,
    3-1-3 bottleneck kernels, with per-term logdet remat so the 256^2
    activations fit HBM."""
    return FlowConfig(
        image_size=256, n_scales=3, blocks_per_scale=5, hidden=128,
        kernel_sizes=(3, 1, 3), n_power_series=6, n_clusters=4,
        warmup_iters=200, remat_logdet=True,
    )


class FlowState(NamedTuple):
    params: Any
    spectral: Any
    opt_state: Any
    ema: EmaState
    step: jnp.ndarray
    key: jax.Array


def build_models(cfg: FlowConfig):
    flow = ResidualFlow(
        n_scales=cfg.n_scales, blocks_per_scale=cfg.blocks_per_scale,
        hidden=cfg.hidden, coeff=cfg.coeff,
        n_power_series=cfg.n_power_series,
        input_shape=(cfg.image_size, cfg.image_size, 1),
        kernel_sizes=tuple(cfg.kernel_sizes),
        remat_logdet=cfg.remat_logdet,
    )
    gmm = ConvGMM(n_clusters=cfg.n_clusters, latent_channels=1)
    return flow, gmm


def make_optimizer(cfg: FlowConfig):
    """Adam + warmup + clip + accumulation (``train_img_horo.py:255-259,
    387-414,577-594``)."""
    if cfg.cosine_restart_period > 0:
        # Optional CosineAnnealingWarmRestarts parity (train_img_horo.py:389).
        tail = optax.sgdr_schedule(
            [
                dict(init_value=cfg.lr, peak_value=cfg.lr,
                     decay_steps=cfg.cosine_restart_period,
                     warmup_steps=0, end_value=0.0)
            ] * 64
        )
    else:
        tail = optax.constant_schedule(cfg.lr)
    schedule = optax.join_schedules(
        [optax.linear_schedule(0.0, cfg.lr, cfg.warmup_iters), tail],
        [cfg.warmup_iters],
    )
    tx = optax.chain(
        optax.clip_by_global_norm(cfg.grad_clip),
        optax.adam(schedule),
    )
    if cfg.update_freq > 1:
        tx = optax.MultiSteps(tx, cfg.update_freq)
    return tx


def init_flow_state(cfg: FlowConfig, key,
                    sample_hsd=None) -> tuple[Any, Any, FlowState, Any]:
    """Build models + state. ``sample_hsd``: a real HSD batch for ActNorm's
    data-dependent init (the reference materializes lazy ActNorm with a real
    forward, ``train_img_horo.py:437-441``); without one, uniform noise is
    used (a constant dummy would put ActNorm's scale at 1/eps)."""
    flow, gmm = build_models(cfg)
    k1, k2, k3, k4 = jax.random.split(key, 4)
    if sample_hsd is not None:
        x0 = jnp.clip(sample_hsd[..., 2:3] / 4.0, 1e-4, 1.0 - 1e-4)
        cond0 = jnp.asarray(sample_hsd[..., :2], jnp.float32)
    else:
        x0 = jax.random.uniform(
            k1, (2, cfg.image_size, cfg.image_size, 1), jnp.float32,
            0.05, 0.95,
        )
        cond0 = jnp.zeros((2, cfg.image_size, cfg.image_size, 2), jnp.float32)
    fvars = flow.init(k1, x0, k2)
    z0, _ = flow.apply(fvars, x0, k2)
    gvars = gmm.init(k3, z0, cond0)
    params = {"flow": fvars["params"], "gmm": gvars["params"]}
    tx = make_optimizer(cfg)
    state = FlowState(
        params=params,
        spectral=fvars.get("spectral", {}),
        opt_state=tx.init(params),
        ema=ema_init(params, cfg.ema_decay),
        step=jnp.int32(0),
        key=k4,
    )
    return flow, gmm, state, tx


def hsd_loss_fn(flow, gmm, cfg: FlowConfig, params, spectral, hsd, key):
    """bits/dim of the density channel under flow+GMM (``compute_loss``,
    ``train_img_horo.py:466-501``): D -> flow -> z; GMM conditioned on
    chroma; logpx = logpz - delta_logp - log(nvals)*dims."""
    d = hsd[..., 2:3]  # density channel in [0, ~inf); squash to (0,1)
    d01 = jnp.clip(d / 4.0, 1e-4, 1.0 - 1e-4)
    cond = hsd[..., :2]

    def flow_fwd(p, x):
        return flow.apply({"params": p, "spectral": spectral}, x, key)

    if cfg.remat:
        # Trade FLOPs for HBM: recompute flow activations in the backward
        # pass (the memory-efficient-backprop role of the reference's
        # --mem-eff flags, train_img_horo.py:91-98, via jax.checkpoint).
        flow_fwd = jax.checkpoint(flow_fwd)
    z, delta_logp = flow_fwd(params["flow"], d01)
    logpz, aux = gmm.apply({"params": params["gmm"]}, z, cond)
    bpd = bits_per_dim(
        logpz, delta_logp, (cfg.image_size, cfg.image_size, 1), cfg.nvals
    )
    return jnp.mean(bpd), aux


def make_train_step(flow, gmm, cfg: FlowConfig, tx,
                    mesh: Optional[Mesh] = None, axis: str = "data"):
    """One compiled update. With a mesh: batch sharded over ``axis``, grads
    pmean'd (the DistributedOptimizer equivalent). Also refreshes the
    spectral-norm estimates (update_lipschitz) after applying updates."""

    def step(state: FlowState, hsd):
        k_loss, k_lip, k_next = jax.random.split(state.key, 3)

        def loss_fn(params):
            loss, _ = hsd_loss_fn(flow, gmm, cfg, params, state.spectral,
                                  hsd, k_loss)
            return loss

        loss, grads = jax.value_and_grad(loss_fn)(state.params)
        if mesh is not None:
            grads = jax.tree.map(lambda g: jax.lax.pmean(g, axis), grads)
            loss = jax.lax.pmean(loss, axis)
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)

        # EMA advances once per REAL optimizer update (the reference applies
        # it after each optimizer.step(), train_img_horo.py:594). Under
        # gradient accumulation MultiSteps leaves params frozen mid-cycle
        # (mini_step != 0 after the update marks an accumulation step), and
        # decaying the shadow toward unchanged params there would shrink
        # the effective EMA horizon by update_freq.
        new_ema = ema_update(state.ema, params)
        if cfg.update_freq > 1:
            applied = opt_state.mini_step == 0
            new_ema = jax.tree.map(
                lambda a, b: jnp.where(applied, a, b),
                new_ema, state.ema,
            )

        # Post-step Lipschitz refresh (train_img_horo.py:1089-1095).
        d01 = jnp.clip(hsd[..., 2:3] / 4.0, 1e-4, 1.0 - 1e-4)
        fvars = update_lipschitz(
            flow, {"params": params["flow"], "spectral": state.spectral},
            d01, k_lip,
        )
        new_state = FlowState(
            params=params,
            spectral=fvars["spectral"],
            opt_state=opt_state,
            ema=new_ema,
            step=state.step + 1,
            key=k_next,
        )
        return new_state, loss

    if mesh is None:
        return jax.jit(step)

    sharded = shard_map(
        step, mesh=mesh,
        in_specs=(P(), P(axis, None, None, None)),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return jax.jit(sharded)


def encode(flow, gmm, params, spectral, cfg: FlowConfig, hsd, key):
    """Eval-mode pass returning (bpd, z, gamma) for deployment/validation.
    gamma is upsampled back to the image grid so color statistics and
    recoloring stay per-pixel regardless of the flow's scale count.

    The flow is fully convolutional (the only size-bound state is the
    spectral power-iteration vector, unused in eval), so ``hsd`` may be any
    spatial size divisible by the squeeze factor — e.g. deploying the
    256-trained capacity checkpoint on 128^2 tiles. bpd and gamma use the
    input's ACTUAL size, not ``cfg.image_size``."""
    from stainlib_tpu.models.gmm import upsample_gamma

    h, w = hsd.shape[-3], hsd.shape[-2]
    d01 = jnp.clip(hsd[..., 2:3] / 4.0, 1e-4, 1.0 - 1e-4)
    z, delta_logp = flow.apply({"params": params["flow"],
                                "spectral": spectral}, d01, key)
    logpz, (mu, sigma, gamma) = gmm.apply({"params": params["gmm"]}, z,
                                          hsd[..., :2])
    bpd = bits_per_dim(logpz, delta_logp, (h, w, 1), cfg.nvals)
    gamma = upsample_gamma(gamma, h, w)
    return bpd, z, gamma
