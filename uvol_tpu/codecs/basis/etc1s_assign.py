"""Exact ETC1S endpoint assignment: the XLA formulation and a fused GPU
kernel (Pallas through Triton).

The stage picks, for every 4x4 block, the endpoint e (base color plus
intensity table) with the least clip-aware block error

    err(b, e) = sum_px min_j |p_px - base_e - m_eff[e, j]|^2

with m_eff[e, j, c] = clip(base_ec + m_j) - base_ec. Dropping the
per-block constant sum |p|^2 leaves

    err'(b, e) = sum_px min_j (q[e, j] - 2 p_px . m_eff[e, j])
                 + 16 |base_e|^2 - 2 psum_b . base_e

with q[e, j] = 2 base_e . m_eff[e, j] + |m_eff[e, j]|^2. It runs once per
exact-metric Lloyd iteration of the palette build
(`etc1s_encode._palette_core_fn`).

EXACT INTEGER SEMANTICS. Pixels, base colors and effective modifiers are
integers, and every product and partial sum below stays under 2^24, so
each per-pixel candidate is an exact integer in f32. The per-pixel minima
are cast to int32 before the 16-pixel sum (block sums exceed 2^24), so
the final errors are exact integers whose value does not depend on the
order of summation. Both formulations resolve argmin ties to the lowest
endpoint index, so they return identical assignments.

- `assign_endpoints_xla`: the plain formulation, a scan over endpoint
  chunks of 16. It is the reference and the path on the CPU.
- `assign_endpoints_triton`: one fused pass. Each program owns TILE_B
  blocks, loops over endpoint tiles of TILE_E inside the kernel and keeps
  the running minimum and argmin in registers, so no [N, 16, E, 4]
  intermediate ever reaches device memory. The K=3 contraction is three
  FMAs per candidate on the CUDA cores: it is far below tensor-core
  shapes, and TF32 would break the exact-integer contract.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

#: per-pixel candidate for padded endpoints: 16 * _PAD_Q stays far above
#: any real block error (<= ~42M) and far below int32 max
_PAD_Q = 4.0e6

#: blocks per program, endpoints per tile, and the Triton launch shape,
#: chosen by a sweep on an H100 (PERF.md). Few blocks per program keep
#: the 48 per-pixel row vectors to a register or two per thread; wider
#: block tiles spill and run 5-30x slower. num_stages does not matter:
#: the loop's loads are a few KB of L2-resident constants.
TILE_B = 2
TILE_E = 256
NUM_WARPS = 4
NUM_STAGES = 1

_CONST_ROWS = 20


def use_gpu_kernel(platform: str) -> bool:
    """True when the stage runs as the Triton kernel on `platform`.

    `platform` is the JAX platform of the devices that hold the blocks:
    the kernel on "gpu", the XLA formulation everywhere else. A GPU run
    whose kernel fails to lower raises; it never falls back."""
    return platform == "gpu"


def effective_modifiers(basef, inten_rows):
    """Clip-aware effective modifiers and per-code constants.

    basef [E, 3] f32 integer base colors, inten_rows [E, 4] the
    endpoints' intensity modifiers -> (me_e [E, 4, 3], q_ej [E, 4])."""
    me_e = (
        jnp.clip(basef[:, None, :] + inten_rows[:, :, None], 0.0, 255.0)
        - basef[:, None, :]
    )
    q_ej = 2.0 * jnp.einsum(
        "ec,ejc->ej", basef, me_e,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    ) + jnp.sum(me_e**2, -1)
    return me_e, q_ej


def assign_endpoints_xla(blocks, basef, me_e, q_ej, echunk: int = 16):
    """Plain formulation: blocks [N, 16, 3] f32 -> assign [N] int32."""
    e = basef.shape[0]
    n_chunks = -(-e // echunk)
    e_pad = n_chunks * echunk
    p_sum = jnp.sum(blocks, axis=1)  # [N, 3]
    color_cross = jnp.dot(
        p_sum, basef.T, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )  # [N, E]
    base_sq = 16.0 * jnp.sum(basef**2, axis=1)  # [E]
    me_p = jnp.pad(me_e, ((0, e_pad - e), (0, 0), (0, 0)))
    q_p = jnp.pad(q_ej, ((0, e_pad - e), (0, 0)))

    def chunk(carry, xs):
        me_c, q_c = xs  # [C, 4, 3], [C, 4]
        p_cross = jnp.einsum(
            "npc,kjc->npkj", blocks, me_c,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )  # [N, 16, C, 4]
        cand = q_c[None, None] - 2.0 * p_cross
        return carry, jnp.sum(
            jnp.min(cand, axis=-1).astype(jnp.int32), axis=1
        )  # [N, C] int32

    _, mod_err = jax.lax.scan(
        chunk,
        0,
        (me_p.reshape(n_chunks, echunk, 4, 3), q_p.reshape(n_chunks, echunk, 4)),
    )  # [n_chunks, N, C]
    mod_err = jnp.moveaxis(mod_err, 0, 1).reshape(-1, e_pad)[:, :e]
    err = mod_err + (base_sq[None, :] - 2.0 * color_cross).astype(jnp.int32)
    return jnp.argmin(err, axis=1).astype(jnp.int32)


def endpoint_const_rows(basef, me_e, q_ej):
    """[20, E_pad] kernel constants, E padded to a multiple of TILE_E.

    Rows 4j..4j+3 hold [-2 me_r; -2 me_g; -2 me_b; q] for code j, rows
    16..19 [-2 base_r; -2 base_g; -2 base_b; 16 |base|^2]. Padded endpoint
    columns get q = _PAD_Q so they never win the argmin."""
    e = basef.shape[0]
    e_pad = -(-e // TILE_E) * TILE_E
    rows = []
    for j in range(4):
        rows.append(-2.0 * me_e[:, j, :].T)  # [3, E]
        rows.append(q_ej[:, j][None, :])  # [1, E]
    rows.append(-2.0 * basef.T)  # [3, E]
    rows.append(16.0 * jnp.sum(basef * basef, axis=1)[None, :])  # [1, E]
    const = jnp.concatenate(rows, axis=0).astype(jnp.float32)
    if e_pad != e:
        pad = jnp.zeros((_CONST_ROWS, e_pad - e), jnp.float32)
        pad = pad.at[(3, 7, 11, 15), :].set(_PAD_Q)
        const = jnp.concatenate([const, pad], axis=1)
    return const


def pixel_planes(blocks_u8):
    """[N, 16, 3] uint8 blocks -> [48, N_pad] f32 planes (row c*16 + p,
    blocks on the minor axis), N padded to a multiple of TILE_B."""
    n = blocks_u8.shape[0]
    n_pad = -(-n // TILE_B) * TILE_B
    planes = jnp.transpose(blocks_u8, (2, 1, 0)).reshape(48, n)
    return jnp.pad(planes, ((0, 0), (0, n_pad - n))).astype(jnp.float32)


def _assign_kernel(px_ref, const_ref, out_ref, *, tb, te, n_pad, e_pad):
    # px_ref [48 * n_pad] and const_ref [20 * e_pad] are flat f32 views;
    # every load is one coalesced row segment of the program's tile
    b = pl.program_id(0) * tb + jnp.arange(tb)
    px = [
        [plgpu.load(px_ref.at[(c * 16 + p) * n_pad + b]) for c in range(3)]
        for p in range(16)
    ]  # 48 x [tb]
    psum = [sum(px[p][c] for p in range(16)) for c in range(3)]  # exact

    def tile(t, carry):
        best_err, best_idx = carry
        e = t * te + jnp.arange(te)
        k = [plgpu.load(const_ref.at[r * e_pad + e]) for r in range(_CONST_ROWS)]
        cross = (
            k[19][None, :]
            + psum[0][:, None] * k[16][None, :]
            + psum[1][:, None] * k[17][None, :]
            + psum[2][:, None] * k[18][None, :]
        )  # [tb, te] exact integers
        err = cross.astype(jnp.int32)
        for p in range(16):
            best = None
            for j in range(4):
                cand = (
                    k[4 * j + 3][None, :]
                    + px[p][0][:, None] * k[4 * j][None, :]
                    + px[p][1][:, None] * k[4 * j + 1][None, :]
                    + px[p][2][:, None] * k[4 * j + 2][None, :]
                )
                best = cand if best is None else jnp.minimum(best, cand)
            err = err + best.astype(jnp.int32)
        mn = jnp.min(err, axis=1)
        idx = jnp.min(
            jnp.where(err == mn[:, None], e[None, :], jnp.int32(2**30)), axis=1
        )  # lowest index among the tile's minima
        better = mn < best_err  # strict: earlier tiles keep ties
        return (
            jnp.where(better, mn, best_err),
            jnp.where(better, idx, best_idx),
        )

    init = (
        jnp.full((tb,), jnp.iinfo(jnp.int32).max, jnp.int32),
        jnp.zeros((tb,), jnp.int32),
    )
    _, best_idx = jax.lax.fori_loop(0, e_pad // te, tile, init)
    plgpu.store(out_ref.at[b], best_idx)


@functools.partial(jax.jit, static_argnames=("n", "interpret"))
def assign_endpoints_triton(planes, const_rows, *, n: int, interpret: bool = False):
    """planes [48, N_pad] from `pixel_planes`, const_rows [20, E_pad] from
    `endpoint_const_rows` -> assign [n] int32."""
    n_pad = planes.shape[1]
    e_pad = const_rows.shape[1]
    if n_pad % TILE_B or e_pad % TILE_E:
        raise ValueError(
            f"planes ({n_pad}) / const rows ({e_pad}) not padded to the "
            f"tiles ({TILE_B}, {TILE_E})"
        )
    out = pl.pallas_call(
        functools.partial(
            _assign_kernel, tb=TILE_B, te=TILE_E, n_pad=n_pad, e_pad=e_pad
        ),
        out_shape=jax.ShapeDtypeStruct((n_pad,), jnp.int32),
        grid=(n_pad // TILE_B,),
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=NUM_WARPS, num_stages=NUM_STAGES
        ),
        interpret=interpret,
        name="etc1s_endpoint_assign",
    )(planes.reshape(-1), const_rows.reshape(-1))
    return out[:n]
