"""Data-parallel trial execution over a device mesh.

Design (device-batched replacement for the reference's thread pool,
src/simulation.cpp:693-768):

  * one mesh axis ``data`` spans all devices (every card of a host, and
    other hosts after ``jax.distributed.initialize``);
  * the per-device program is *identical* to the single-chip trial step
    (simulation._build_step): key generation, exact-count error injection,
    frame extension, batched decode — all purely batch-local, so the decode
    itself needs **zero** cross-device communication;
  * each device derives an independent PRNG stream by folding its
    ``data``-axis index into the trial keys (the mesh analogue of the
    reference's per-trial seed offsets, src/simulation.cpp:743);
  * per-frame outcomes come back sharded over ``data``; scalar statistics
    are reduced on device with ``psum`` so only a handful of numbers cross
    to the host (see ``sharded_step``'s reduce mode).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from qkd_ldpc_v_tpu.config import Config
from qkd_ldpc_v_tpu.models.hmatrix import HMatrix
from qkd_ldpc_v_tpu.simulation import _build_step
from qkd_ldpc_v_tpu.utils import PlanCache


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Multi-host bring-up (GPU hosts / CPU fleets): thin wrapper over
    ``jax.distributed.initialize`` so callers need no jax.distributed import.
    On single-process runs this is a no-op."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def make_data_mesh(
    n_devices: Optional[int] = None, devices: Optional[Sequence] = None
) -> Mesh:
    """1-D ``data`` mesh over the first ``n_devices`` devices (default all)."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    import numpy as np

    return Mesh(np.asarray(devices), axis_names=("data",))


def sharded_step(
    matrix: HMatrix,
    cfg: Config,
    global_batch: int,
    mesh: Mesh,
    reduce_stats: bool = False,
) -> Callable:
    """Build the mesh-sharded trial step.

    Returns a jitted function with the same signature as the single-device
    step but decoding ``global_batch`` frames spread over ``mesh``'s ``data``
    axis. ``global_batch`` must divide evenly (callers round up; surplus
    frames are sliced off host-side exactly like a short final chunk).

    The per-device program is the single-device step (decoder and schedule
    chosen the same way). Two-phase straggler re-decode is the one
    single-device feature the mesh path drops — it needs host-side straggler
    indices, which contradicts on-device aggregation; run_combination warns
    when a config would have used it.

    ``reduce_stats=True`` builds the fully-distributed aggregation mode for
    multi-host campaigns: the step takes one extra ``valid_count`` scalar
    (frames with global index >= valid_count are masked out — the short
    final chunk) and returns the six ``psum_stats`` scalars instead of
    per-frame arrays, so per-chunk host traffic is O(1) regardless of the
    global batch (reference aggregation semantics:
    src/simulation.cpp:580-690). The returned callable carries
    ``.reduces = True`` so run_combination switches its accumulation.
    """
    n_dev = mesh.devices.size
    if global_batch % n_dev:
        raise ValueError(
            f"global batch {global_batch} not divisible by mesh size {n_dev}"
        )
    local_batch = global_batch // n_dev
    local = _build_step(
        matrix,
        cfg.decoding_algorithm,
        cfg.decoding_alg_max_iterations,
        cfg.enable_msg_llr_threshold,
        cfg.enable_code_rate_adaptation,
        local_batch,
        cfg.dtype,
        schedule=cfg.schedule,
    )

    def run_local(ka, ke, kp, qber, num_errors, primary, secondary,
                  threshold, pos_class, payload_gather):
        idx = jax.lax.axis_index("data")
        ka = jax.random.fold_in(ka, idx)
        ke = jax.random.fold_in(ke, idx)
        kp = jax.random.fold_in(kp, idx)
        return local(
            ka, ke, kp, qber, num_errors, primary, secondary, threshold,
            pos_class, payload_gather,
        )

    rep = P()  # replicated scalars / index vectors

    if not reduce_stats:
        fn = shard_map(
            run_local,
            mesh=mesh,
            in_specs=(rep,) * 10,
            out_specs=(P("data"), P("data"), P("data")),
            check_vma=False,
        )
        jitted = jax.jit(fn)

        def step(*args):
            return jitted(*args)

        step.reduces = False
        return step

    def reduce_worker(ka, ke, kp, qber, num_errors, primary, secondary,
                      threshold, pos_class, payload_gather, valid_count):
        syn, keys, iters = run_local(
            ka, ke, kp, qber, num_errors, primary, secondary, threshold,
            pos_class, payload_gather,
        )
        idx = jax.lax.axis_index("data")
        gidx = idx * local_batch + jnp.arange(local_batch)
        valid = gidx < valid_count
        return psum_stats(syn & valid, keys, iters)

    fn = shard_map(
        reduce_worker,
        mesh=mesh,
        in_specs=(rep,) * 11,
        out_specs=(P(),) * 6,
        check_vma=False,
    )
    jitted = jax.jit(fn)

    def step(*args):
        return jitted(*args)

    step.reduces = True
    return step


def mesh_step_factory(mesh: Mesh, reduce_stats: bool = False) -> Callable:
    """A ``step_factory`` for simulation.run_combination that shards each
    combination's trial batches over ``mesh``. Rounds the requested batch up
    to a multiple of the mesh size (the driver slices surplus frames off;
    with ``reduce_stats`` the surplus is masked on device instead and only
    scalar statistics ever reach the host — see sharded_step)."""
    cache = PlanCache()

    def factory(matrix: HMatrix, cfg: Config, batch: int) -> Callable:
        n_dev = mesh.devices.size
        global_batch = ((batch + n_dev - 1) // n_dev) * n_dev
        key = (
            cfg.decoding_algorithm,
            cfg.decoding_alg_max_iterations,
            cfg.enable_msg_llr_threshold,
            cfg.enable_code_rate_adaptation,
            global_batch,
            cfg.dtype,
            cfg.schedule,
            reduce_stats,
        )
        fn = cache.get(matrix, extra=key)
        if fn is None:
            fn = sharded_step(
                matrix, cfg, global_batch, mesh, reduce_stats=reduce_stats
            )
            cache.put(matrix, fn, extra=key)
        return fn

    return factory


def psum_stats(syndromes_match, keys_match, iterations, axis_name: str = "data"):
    """On-device statistic reduction for fully-distributed aggregation:
    returns (n_success_dec, n_success_ldpc, iter_sum, iter_m2, iter_min,
    iter_max) reduced over the mesh axis — the psum/pmin/pmax analogue of the
    reference's host-side aggregation loop (src/simulation.cpp:587-624).
    Call from inside a shard_map worker when per-frame arrays are too large
    to gather (multi-host campaigns).

    ``iter_m2`` is the sum of squared deviations from the *global* mesh mean
    (Chan's parallel-variance formulation), not the raw sum of squares: the
    E[x^2]-E[x]^2 form loses its low bits to cancellation in float32 (the
    accumulation dtype without x64) once chunks grow large, skewing
    ITERATIONS_STD; deviations from the mean stay small and cancel nothing.
    The extra psum is one more scalar all-reduce per chunk."""
    ok = syndromes_match
    okf = ok.astype(jnp.float64) if jax.config.jax_enable_x64 else ok.astype(jnp.float32)
    it = iterations.astype(okf.dtype)
    big = jnp.asarray(jnp.iinfo(jnp.int32).max, it.dtype)
    n_dec = jax.lax.psum(jnp.sum(okf), axis_name)
    n_ldpc = jax.lax.psum(
        jnp.sum(okf * keys_match.astype(okf.dtype)), axis_name
    )
    it_sum = jax.lax.psum(jnp.sum(jnp.where(ok, it, 0.0)), axis_name)
    mean = it_sum / jnp.maximum(n_dec, 1.0)
    dev = it - mean
    it_m2 = jax.lax.psum(jnp.sum(jnp.where(ok, dev * dev, 0.0)), axis_name)
    it_min = jax.lax.pmin(jnp.min(jnp.where(ok, it, big)), axis_name)
    it_max = jax.lax.pmax(jnp.max(jnp.where(ok, it, -1.0)), axis_name)
    return n_dec, n_ldpc, it_sum, it_m2, it_min, it_max


def edge_sharded_decoder(
    layout,
    algorithm,
    max_iterations: int,
    mesh: Mesh,
    axis: str = "model",
    dtype=None,
):
    """Generic decoder with its edge-message state sharded over a mesh axis.

    The model/sequence-parallel analogue from SURVEY.md §5: for frames whose
    edge state exceeds one device's memory, every flat ``[E, B]`` message
    array inside the decode loop carries a sharding constraint over ``axis``
    and XLA's SPMD partitioner inserts the collectives for the
    cross-enumeration regroup gathers. Results are identical to the
    unsharded decoder (the jnp program is unchanged).
    """
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    from qkd_ldpc_v_tpu.ops.decoders import make_decoder

    sharding = NamedSharding(mesh, P(axis, None))

    def constrain(x):
        return jax.lax.with_sharding_constraint(x, sharding)

    decode = make_decoder(
        layout, algorithm, max_iterations, False,
        jnp.float32 if dtype is None else dtype,
        edge_constraint=constrain,
    )
    return jax.jit(decode)
