"""Batched channel model and protocol primitives.

Mirrors the reference's key generation / error injection / syndrome semantics
(reference: src/array_and_matrix_operations.cpp:889-950) for a whole batch of
Monte-Carlo trials at once:

  * Alice keys: uniform bits per frame.
  * Bob keys: Alice's key with an **exact** count of ``floor(N * QBER)``
    errors at uniformly random distinct positions per frame (the reference
    shuffles a position vector; we rank i.i.d. uniforms, which induces the
    same uniform distribution over position subsets).
  * Syndrome: XOR of key bits over each check row, computed in the
    degree-grouped layout as a gather + parity reduction.

PRNG discipline: jax threefry keys, one key per (combination, trial-chunk),
folded from the config's simulation seed — deterministic and
counter-based like the reference's per-trial Xoshiro seeding
(src/simulation.cpp:713-719), but with no sequential stream.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from qkd_ldpc_v_tpu.models.layout import EdgeLayout


def exact_error_count(num_bits: int, qber: float) -> int:
    """floor(N * QBER) (reference: src/array_and_matrix_operations.cpp:913)."""
    return int(num_bits * qber)


def generate_keys(key: jax.Array, batch: int, num_bits: int) -> jax.Array:
    """Alice's keys: uniform bits, shape [batch, num_bits] int8."""
    return jax.random.bernoulli(key, 0.5, (batch, num_bits)).astype(jnp.int8)


def inject_errors(
    key: jax.Array, alice: jax.Array, num_errors: jax.Array | int
) -> jax.Array:
    """Bob's keys: flip exactly ``num_errors`` distinct positions per frame.

    Positions are the ranks of the smallest per-position sort keys — a
    uniformly random subset of exactly that size, matching the reference's
    shuffled position vector (src/array_and_matrix_operations.cpp:917-931).
    Sort keys are random high bits with the position index in the low bits:
    all keys are distinct by construction, so the count is *exact* even when
    raw random draws collide (f32 uniforms tie at the threshold in ~0.1% of
    10k-bit frames; the positions carrying a tied draw are exchangeable, so
    index tie-breaking keeps the subset distribution uniform).
    """
    batch, n = alice.shape
    if jax.config.jax_enable_x64:
        # 64-bit keys: random high 32 bits, position low 32 — no random-bit
        # budget is spent on the index, so no tie-class bias at any n.
        bits = jax.random.bits(key, (batch, n), jnp.uint32).astype(jnp.uint64)
        pos = jax.lax.broadcasted_iota(jnp.uint64, (batch, n), 1)
        keys = (bits << 32) | pos
    else:
        # 32-bit fallback: random high bits, index low bits. Ties at the
        # selection boundary slightly favor low indices; the affected count
        # per frame is ~n^2 / (K * 2^(32-ceil(log2 n))) positions — under
        # 4 even at n = 102400 — negligible for the supported frame sizes.
        idx_bits = max(1, (n - 1).bit_length())
        bits = jax.random.bits(key, (batch, n), jnp.uint32)
        pos = jax.lax.broadcasted_iota(jnp.uint32, (batch, n), 1)
        keys = (bits >> idx_bits << idx_bits) | pos
    sk = jnp.sort(keys, axis=1)
    ne = jnp.broadcast_to(jnp.asarray(num_errors, dtype=jnp.int32), (batch,))
    kth = jnp.take_along_axis(
        sk, jnp.maximum(ne - 1, 0)[:, None], axis=1
    )[:, 0]
    flips = ((keys <= kth[:, None]) & (ne > 0)[:, None]).astype(jnp.int8)
    return alice ^ flips


def llr_from_bits(bits: jax.Array, qber, dtype=jnp.float32) -> jax.Array:
    """Channel LLRs: +/- log((1-q)/q) by Bob's bit value
    (reference: src/qkd_ldpc_algorithm.cpp:1043-1049)."""
    log_p = jnp.log((1.0 - qber) / qber).astype(dtype)
    return jnp.where(bits == 1, -log_p, log_p).astype(dtype)


def syndrome_internal(layout: EdgeLayout, bits_int: jax.Array) -> jax.Array:
    """Syndrome in internal (degree-sorted) check order.

    bits_int: [batch, N] int8 in internal bit order -> [batch, M] int8.
    """
    edges = jnp.take(bits_int, jnp.asarray(layout.check_edge_bit), axis=1)
    parts = []
    for g in layout.check_groups:
        size = g.count * g.degree
        grp = edges[:, g.edge_offset : g.edge_offset + size].reshape(
            bits_int.shape[0], g.count, g.degree
        )
        parts.append(jnp.sum(grp, axis=-1, dtype=jnp.int32) & 1)
    return jnp.concatenate(parts, axis=1).astype(jnp.int8)


def calculate_syndrome(layout: EdgeLayout, bits_ext: jax.Array) -> jax.Array:
    """Syndrome in external check order for keys in external bit order
    (reference: src/array_and_matrix_operations.cpp:936-950)."""
    bits_int = jnp.take(bits_ext, jnp.asarray(layout.bit_order), axis=1)
    syn_int = syndrome_internal(layout, bits_int)
    return jnp.take(syn_int, jnp.asarray(layout.check_inv), axis=1)


def trial_keys(seed: int, sim_number: int, chunk_index: int) -> jax.Array:
    """Derive the (alice, errors, punctured) PRNG keys for one decode chunk.

    Counter-based analogue of the reference's `seeds[n] + curr_sim` per-trial
    discipline (src/simulation.cpp:743).
    """
    base = jax.random.PRNGKey(seed)
    k = jax.random.fold_in(jax.random.fold_in(base, sim_number), chunk_index)
    return jax.random.split(k, 3)
