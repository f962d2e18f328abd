"""Distribution-layer tests on the virtual 8-device CPU mesh
(conftest forces ``xla_force_host_platform_device_count=8``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qkd_ldpc_v_tpu.config import Config, DecodingAlgorithm, RQBERRange
from qkd_ldpc_v_tpu.parallel import make_data_mesh, mesh_step_factory, sharded_step
from qkd_ldpc_v_tpu.parallel.driver import psum_stats
from qkd_ldpc_v_tpu.rate_adapt import HMatrixParams
from qkd_ldpc_v_tpu.simulation import (
    SimCombination,
    ScalingFactors,
    run_combination,
)


def _cfg(**kw):
    defaults = dict(
        trials_number=32,
        simulation_seed=9,
        decoding_algorithm=DecodingAlgorithm.SPA,
        decoding_alg_max_iterations=40,
        r_qber_ranges=(RQBERRange(0.99, 0.02, 0.02, 0.01),),
    )
    defaults.update(kw)
    return Config(**defaults)


def test_mesh_has_8_devices():
    mesh = make_data_mesh()
    assert mesh.devices.size == 8


def test_sharded_step_outputs_sharded(medium_matrix):
    mesh = make_data_mesh()
    cfg = _cfg()
    step = sharded_step(medium_matrix, cfg, global_batch=32, mesh=mesh)
    from qkd_ldpc_v_tpu.ops.channel import trial_keys
    from qkd_ldpc_v_tpu.simulation import make_frame_plan

    ka, ke, kp = trial_keys(9, 0, 0)
    pos_class, gather = make_frame_plan(512, HMatrixParams())
    syn, keys, iters = step(
        ka, ke, kp,
        jnp.float32(0.02), jnp.int32(10),
        jnp.float32(1.0), jnp.float32(1.0), jnp.float32(0.0),
        jnp.asarray(pos_class), jnp.asarray(gather),
    )
    assert syn.shape == (32,)
    # sharded over the data axis: 8 shards of 4 frames
    assert len(syn.sharding.device_set) == 8
    # sanity: at QBER 0.02 most frames decode
    assert int(jnp.sum(syn)) > 16


def test_run_combination_with_mesh_factory(medium_matrix):
    cfg = _cfg(trials_number=32)
    mesh = make_data_mesh()
    comb = SimCombination(0.02, HMatrixParams(), ScalingFactors())
    res = run_combination(
        medium_matrix, comb, cfg, sim_number=0,
        step_factory=mesh_step_factory(mesh),
    )
    assert res.ratio_trials_success_ldpc > 0.7
    assert 0 < res.iter_success_mean <= 40


def test_mesh_factory_rounds_up_batch(medium_matrix):
    """trials=30 on 8 devices -> global batch 32, surplus sliced off."""
    cfg = _cfg(trials_number=30)
    mesh = make_data_mesh()
    comb = SimCombination(0.02, HMatrixParams(), ScalingFactors())
    res = run_combination(
        medium_matrix, comb, cfg, sim_number=0,
        step_factory=mesh_step_factory(mesh),
    )
    assert 0.0 <= res.ratio_trials_success_ldpc <= 1.0


def test_psum_stats_matches_host_aggregation():
    mesh = make_data_mesh()
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    rng = np.random.default_rng(0)
    syn = rng.random(64) < 0.8
    keys = syn & (rng.random(64) < 0.9)
    iters = rng.integers(1, 40, 64)

    fn = shard_map(
        lambda s, k, i: psum_stats(s, k, i),
        mesh=mesh,
        in_specs=(P("data"), P("data"), P("data")),
        out_specs=(P(),) * 6,
        check_vma=False,
    )
    n_dec, n_ldpc, it_sum, it_m2, it_min, it_max = jax.device_get(
        fn(jnp.asarray(syn), jnp.asarray(keys), jnp.asarray(iters))
    )
    assert n_dec == syn.sum()
    assert n_ldpc == (syn & keys).sum()
    assert it_sum == pytest.approx(iters[syn].sum())
    # M2 = sum of squared deviations about the global mean (Chan form)
    sel = iters[syn].astype(float)
    assert it_m2 == pytest.approx(((sel - sel.mean()) ** 2).sum())
    assert it_min == iters[syn].min()
    assert it_max == iters[syn].max()


def test_reduce_mode_matches_gathered_mode(medium_matrix):
    """reduce_stats=True moves only six scalars per chunk to the host; the
    resulting statistics must equal the gathered per-frame path exactly
    (same mesh, same PRNG folding, same trials)."""
    cfg = _cfg(trials_number=48, batch_size=16)  # 3 chunks of 16
    mesh = make_data_mesh()
    comb = SimCombination(0.02, HMatrixParams(), ScalingFactors())
    gathered = run_combination(
        medium_matrix, comb, cfg, sim_number=0,
        step_factory=mesh_step_factory(mesh),
    )
    reduced = run_combination(
        medium_matrix, comb, cfg, sim_number=0,
        step_factory=mesh_step_factory(mesh, reduce_stats=True),
    )
    assert reduced.ratio_trials_success_ldpc == gathered.ratio_trials_success_ldpc
    assert reduced.ratio_trials_success_decoding == (
        gathered.ratio_trials_success_decoding
    )
    assert reduced.iter_success_mean == pytest.approx(gathered.iter_success_mean)
    assert reduced.iter_success_std == pytest.approx(gathered.iter_success_std)
    assert reduced.iter_success_min == gathered.iter_success_min
    assert reduced.iter_success_max == gathered.iter_success_max


def test_reduce_mode_masks_short_final_chunk(medium_matrix):
    """trials=20 on 8 devices -> global batch 24; the 4 surplus frames must
    be masked on device, not counted."""
    cfg = _cfg(trials_number=20)
    mesh = make_data_mesh()
    comb = SimCombination(0.02, HMatrixParams(), ScalingFactors())
    reduced = run_combination(
        medium_matrix, comb, cfg, sim_number=0,
        step_factory=mesh_step_factory(mesh, reduce_stats=True),
    )
    # denominators are the requested 20 trials; a mask bug would push the
    # success ratio above 1 or count ghost successes
    assert 0.0 <= reduced.ratio_trials_success_ldpc <= 1.0
    gathered = run_combination(
        medium_matrix, comb, cfg, sim_number=0,
        step_factory=mesh_step_factory(mesh),
    )
    assert reduced.ratio_trials_success_ldpc == gathered.ratio_trials_success_ldpc
    assert reduced.iter_success_mean == pytest.approx(gathered.iter_success_mean)


def test_scaling_report_script_runs():
    """CI-style exercise of scripts/scaling_report.py on the CPU mesh."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    out = subprocess.run(
        [sys.executable, str(root / "scripts" / "scaling_report.py"),
         "--trials", "64", "--bits", "512", "--max-iters", "20",
         "--max-devices", "2", "--qber", "0.02", "--reduce-stats"],
        capture_output=True, text=True, timeout=600,
        env={**__import__("os").environ,
             "JAX_PLATFORMS": "cpu",
             "XLA_FLAGS": "--xla_force_host_platform_device_count=8"},
    )
    assert out.returncode == 0, out.stderr[-2000:]
    payload = json.loads(out.stdout.strip().splitlines()[-1])
    assert payload["metric"] == "scaling"
    assert [r["devices"] for r in payload["results"]] == [1, 2]
    assert all(r["frames_per_s"] > 0 for r in payload["results"])


def test_edge_sharded_decoder_matches_unsharded(medium_matrix):
    """Edge-axis sharding (the model-parallel analogue): identical results,
    XLA inserts the regroup collectives."""
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from qkd_ldpc_v_tpu.models.layout import layout_for
    from qkd_ldpc_v_tpu.ops.channel import calculate_syndrome
    from qkd_ldpc_v_tpu.ops.decoders import make_decoder
    from qkd_ldpc_v_tpu.parallel.driver import edge_sharded_decoder

    layout = layout_for(medium_matrix)
    mesh = Mesh(np.asarray(jax.devices()[:2]), axis_names=("model",))
    sharded = edge_sharded_decoder(layout, DecodingAlgorithm.NMSA, 30, mesh)
    plain = jax.jit(make_decoder(layout, DecodingAlgorithm.NMSA, 30, False))

    rng = np.random.default_rng(0)
    n = medium_matrix.num_bit_nodes
    alice = jnp.asarray(rng.integers(0, 2, (4, n)), jnp.int8)
    bob = alice ^ jnp.asarray(rng.random((4, n)) < 0.03, jnp.int8)
    log_p = float(np.log(0.97 / 0.03))
    llr = jnp.where(bob == 1, -log_p, log_p).astype(jnp.float32)
    syn = calculate_syndrome(layout, alice)

    rs = sharded(llr, syn, 0.8, 1.0, 0.0)
    rp = plain(llr, syn, 0.8, 1.0, 0.0)
    np.testing.assert_array_equal(np.asarray(rs.decision), np.asarray(rp.decision))
    np.testing.assert_array_equal(
        np.asarray(rs.iterations), np.asarray(rp.iterations)
    )
