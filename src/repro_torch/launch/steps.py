"""Step functions (train / prefill / decode) with the logical-axis
plumbing (port of ``repro/launch/steps.py``).

The reference builds jitted, GSPMD-sharded steps over a mesh and returns
them with abstract arguments, so that the dry run lowers the exact
production step.  The port has one device a process and holds the
parameters in the model: :func:`build_prefill_step`,
:func:`build_decode_step` and :func:`build_step` return a
:class:`StepBundle` whose model is on the ``meta`` device and whose
``args`` are ``meta`` tensors of the reference's arguments (the
parameters by the reference's paths, the optimizer state or the cache,
the inputs of ``configs.input_specs``), each with its spec on the grid
(``specs``).  The dry run (:mod:`repro_torch.launch.dryrun`) sums the
shards; the bundle runs once its model is drawn (``bundle.model.init``,
or ``init`` then ``quantize``).

:func:`build_train_step` sums microbatch gradients into f32 buffers, as
the reference's scan sums them: torch adds a second ``backward()`` into
``.grad`` in the parameter's dtype (bf16), so each microbatch's
gradients are added to the f32 sums and released.  With a data-parallel
group each rank takes its rows of the batch (``batch_sharding``), the
f32 sums and losses are all-reduced, and AdamW updates each rank's
``fsdp`` shard of every leaf (its moments held for that shard alone,
ZeRO-1) before the updated shards are all-gathered.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from repro_torch import optim
from repro_torch.configs import SHAPES, input_specs
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import reference_paths
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.parallel.sharding import (DEFAULT_RULES, batch_sharding,
                                           cache_axes, input_shardings,
                                           local_slices, make_shardings,
                                           param_axes, resolve_spec)
from repro_torch.training.trainer import (device_batch, grads_of,
                                          simple_train_step,
                                          trained_parameters)


@dataclass
class StepBundle:
    """``fn`` takes the reference's arguments less the parameters (the
    model holds them): a train step ``fn(opt_state, batch) -> metrics``
    (the model and the state updated in place), a serving step
    ``fn(batch, cache) -> (logits, cache)``.  ``args`` are the
    reference's arguments as ``meta`` tensors, the parameters first:
    train ``(params, opt_state, batch)``, prefill and decode ``(params,
    batch, cache)``; ``specs`` the same tree of per-leaf specs."""
    fn: Callable
    args: tuple
    model: Any
    kind: str
    specs: tuple = ()


def optimizer_config(cfg: ModelConfig) -> optim.AdamWConfig:
    # XXL models keep moments in bf16 so training state fits memory.
    big = cfg.param_count() > 1e11
    return optim.AdamWConfig(learning_rate=3e-4,
                             moment_dtype="bfloat16" if big else "float32")


# ---------------------------------------------------------------------------
def _zero1(model, params: dict, dp) -> tuple[dict, dict]:
    """(each leaf's slices of this rank's ``fsdp`` shard on the grid
    {"data": P}, the dimension it is cut on, or None where whole)."""
    grid = {"data": dp.size}
    paxes = param_axes(model)
    slices, dims = {}, {}
    for k, p in params.items():
        spec = resolve_spec(tuple(p.shape), paxes[k], grid, DEFAULT_RULES)
        slices[k] = local_slices(tuple(p.shape), spec, grid, dp.rank)
        cut = [i for i, part in enumerate(spec) if part is not None]
        dims[k] = cut[0] if cut else None
    return slices, dims


def build_train_step(cfg: ModelConfig, model,
                     ocfg: Optional[optim.AdamWConfig] = None,
                     dp=None) -> Callable:
    """``step(opt_state, batch) -> metrics`` for ``model`` (``cfg`` its
    config): :func:`~repro_torch.training.simple_train_step` when
    ``cfg.train_microbatches`` is 1 and there is no ``dp`` group, else
    the batch's rows split into microbatches, each one's loss and
    gradients summed in f32 and divided by their count before one AdamW
    update; the metrics are the last microbatch's with the mean loss.

    ``dp``, a group of P ranks (``parallel.context.TPGroup``): the rank
    takes its rows of the batch by ``batch_sharding`` on {"data": P}
    (the batch must divide), in ``train_microbatches / P`` microbatches
    (at least 1) of the single-rank step's rows; the f32 gradient sums
    and the loss sums are all-reduced (SUM) and divided by the global
    microbatch count; AdamW runs on the rank's shard of each leaf under
    its ``fsdp`` axis (``DEFAULT_RULES``), clipping by the whole
    gradients' norm, and each cut leaf's shards are then all-gathered.
    ``step.params`` holds the trained parameters by the reference's
    paths, ``step.shards`` the rank's shards of them (``optim.init(ocfg,
    step.shards)`` makes the state: its moments hold that shard alone),
    ``step.grads`` the last step's mean f32 gradients (whole)."""
    ocfg = ocfg or optimizer_config(cfg)
    mb = max(1, cfg.train_microbatches)
    if mb == 1 and dp is None:
        step = simple_train_step(model, ocfg)
        step.shards = step.params
        return step
    P = 1 if dp is None else dp.size
    local_mb = max(1, mb // P)
    params = trained_parameters(model)
    apply_update = optim.update(ocfg)
    gsum = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}
    slices = dims = None
    shards = params
    if dp is not None:
        slices, dims = _zero1(model, params, dp)
        with torch.no_grad():
            shards = {k: p[slices[k]] for k, p in params.items()}

    def rows_of(b: dict) -> dict:
        rows = next(iter(b.values())).shape[0]
        if dp is None:
            return b
        spec = batch_sharding({"data": P}, batch=rows)
        if spec[0] is None:
            raise ValueError(f"a batch of {rows} rows does not split over "
                             f"{P} data-parallel ranks")
        per = rows // P
        return {k: v[dp.rank * per: (dp.rank + 1) * per]
                for k, v in b.items()}

    def train_step(opt_state: dict, batch: dict) -> dict:
        b = rows_of(device_batch(batch, model.device))
        rows = next(iter(b.values())).shape[0]
        if rows % local_mb:
            raise ValueError(f"a batch of {rows} rows does not split into "
                             f"{local_mb} microbatches")
        per = rows // local_mb
        for g in gsum.values():
            g.zero_()
        lsum = torch.zeros((), dtype=torch.float32, device=model.device)
        for i in range(local_mb):
            micro = {k: v[i * per: (i + 1) * per] for k, v in b.items()}
            for p in params.values():
                p.grad = None
            loss, metrics = model.loss(micro)
            loss.backward()
            for k, g in grads_of(params).items():
                gsum[k].add_(g)
            lsum = lsum + loss.detach()
        for p in params.values():
            p.grad = None
        if dp is not None:
            for g in gsum.values():
                dp.all_reduce_sum(g)
            dp.all_reduce_sum(lsum)
        grads = {k: g.div_(local_mb * P) for k, g in gsum.items()}
        if dp is None:
            om = apply_update(grads, opt_state, params)
        else:
            gnorm = optim.global_norm(grads.values())
            om = apply_update({k: g[slices[k]] for k, g in grads.items()},
                              opt_state, shards, gnorm=gnorm)
            _gather_shards(params, shards, dims, dp)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return dict(metrics, **om, loss=lsum / (local_mb * P))

    train_step.params = params
    train_step.shards = shards
    train_step.grads = gsum
    return train_step


@torch.no_grad()
def _gather_shards(params: dict, shards: dict, dims: dict, dp) -> None:
    """Every cut leaf whole again on every rank: its ranks' updated
    shards gathered along its cut dimension, in rank order."""
    for k, d in dims.items():
        if d is None:
            continue
        whole = dp.all_gather(shards[k].movedim(d, 0).contiguous())
        params[k].copy_(whole.movedim(0, d))


# ---------------------------------------------------------------------------
def _serving_bundle(cfg: ModelConfig, grid, shape: str, rules,
                    kind: str) -> StepBundle:
    from repro_torch.models import Model

    grid = grid or make_smoke_mesh()
    rules = rules or DEFAULT_RULES
    model = Model(cfg)
    cell = SHAPES[shape]
    params = reference_paths(model)
    batch = input_specs(cfg, shape)
    cache = model.init_cache(cell.global_batch, cell.seq_len)
    specs = (make_shardings(grid, params, param_axes(model), rules),
             input_shardings(grid, batch, rules),
             make_shardings(grid, cache, cache_axes(model), rules))

    def prefill_step(batch: dict, cache: list):
        """The logits of each row's last position only [B, 1, vocab] (the
        reference's ``prefill_last``), the caches written."""
        first = batch.get("inputs", batch.get("frame_embeddings"))
        B, S = first.shape[:2]
        if "patch_embeddings" in batch:
            S += batch["patch_embeddings"].shape[1]
        last = torch.full((B,), S - 1, dtype=torch.long,
                          device=first.device)
        with torch.no_grad():
            logits = model(batch.get("inputs"), cache, last_index=last,
                           patch_embeddings=batch.get("patch_embeddings"),
                           frame_embeddings=batch.get("frame_embeddings"))
        return logits, cache

    def decode_step(batch: dict, cache: list):
        """``q_tokens`` new tokens a row against the caches: logits
        [B, q, vocab]."""
        with torch.no_grad():
            logits = model.decode_step(
                batch.get("inputs"), cache,
                frame_embeddings=batch.get("frame_embeddings"))
        return logits, cache

    fn = prefill_step if kind == "prefill" else decode_step
    return StepBundle(fn, (params, batch, cache), model, kind, specs)


def build_prefill_step(cfg: ModelConfig, grid: Optional[dict] = None,
                       shape: str = "prefill_32k",
                       rules: Optional[dict] = None) -> StepBundle:
    return _serving_bundle(cfg, grid, shape, rules, "prefill")


def build_decode_step(cfg: ModelConfig, grid: Optional[dict] = None,
                      shape: str = "decode_32k",
                      rules: Optional[dict] = None) -> StepBundle:
    return _serving_bundle(cfg, grid, shape, rules, "decode")


def _train_bundle(cfg: ModelConfig, grid, shape: str,
                  rules) -> StepBundle:
    """The train step's bundle: ``fn`` builds :func:`build_train_step`
    on its first call (the model drawn by then); its state is
    ``optim.init(optimizer_config(cfg), reference_paths(bundle.model))``
    once the model is drawn."""
    from repro_torch.models import Model

    grid = grid or make_smoke_mesh()
    rules = rules or DEFAULT_RULES
    model = Model(cfg)
    ocfg = optimizer_config(cfg)
    params = reference_paths(model)
    state = optim.init(ocfg, params)
    batch = input_specs(cfg, shape)
    paxes = param_axes(model)
    specs = (make_shardings(grid, params, paxes, rules),
             make_shardings(grid, state, {"mu": paxes, "nu": paxes,
                                          "step": ()}, rules),
             input_shardings(grid, batch, rules))
    built: list = []

    def train_step(opt_state: dict, batch: dict) -> dict:
        if not built:
            built.append(build_train_step(cfg, model, ocfg))
        return built[0](opt_state, batch)

    return StepBundle(train_step, (params, state, batch), model, "train",
                      specs)


def build_step(cfg: ModelConfig, grid: Optional[dict], shape: str,
               rules: Optional[dict] = None) -> StepBundle:
    """The bundle of the cell's step: train, prefill or decode."""
    step = SHAPES[shape].step
    if step == "train":
        return _train_bundle(cfg, grid, shape, rules)
    if step == "prefill":
        return build_prefill_step(cfg, grid, shape, rules)
    return build_decode_step(cfg, grid, shape, rules)
