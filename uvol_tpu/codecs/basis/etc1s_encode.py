"""ETC1S / BasisLZ encoder: frames → supercompressed KTX2 video segments.

Device-side replacement for `basisu -ktx2 -tex_type video` (the reference
texture pipeline, scripts/Encoder.py:286-298). The quality work — global
endpoint/selector palette construction and per-block assignment — is
batched k-means and argmin-by-matmul on the device (`models/codebook.py`,
SURVEY §7 hard part (c)); the wire emission (canonical Huffman streams,
endpoint prediction quads, selector MTF/RLE, conditional replenishment for
P-frames) mirrors `transcoder.py` exactly, so our own transcoder — which is
golden-validated on basisu-produced liam segments — is the format oracle.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from uvol_tpu.codecs.basis.huffman import (
    BitWriter,
    HuffmanEncoder,
    write_vlc,
)
from uvol_tpu.codecs.basis.transcoder import (
    ENDPOINT_PRED_REPEAT_LAST,
    INTEN_TABLES,
    PRED_ABOVE,
    PRED_CR,
    PRED_EXPLICIT,
    PRED_LEFT,
    ApproxMoveToFront,
    COLOR5_PAL0_PREV_HI,
    COLOR5_PAL1_PREV_HI,
)
from uvol_tpu.containers.ktx2 import (
    BasisLZGlobalData,
    KTX2Header,
    KTX2ImageDesc,
    KTX2Level,
    make_basis_dfd,
    write_ktx2,
)


# ---------------------------------------------------------------------------
# Palette construction (device)
# ---------------------------------------------------------------------------


def _extend5(c: np.ndarray) -> np.ndarray:
    return (c << 3) | (c >> 2)


@dataclasses.dataclass
class Palettes:
    color5: np.ndarray  # [E, 3] uint8 (5-bit)
    inten: np.ndarray  # [E] uint8 (3-bit)
    selectors: np.ndarray  # [S, 16] uint8 (2-bit, row-major y*4+x)
    block_endpoint: np.ndarray  # [F, NB] int32
    block_selector: np.ndarray  # [F, NB] int32


_PALETTE_JIT_CACHE: Dict[Tuple, object] = {}


_ONEHOT_ELEM_BUDGET = 1 << 27  # peak one-hot tile <= 512 MB f32


def _onehot_rows(idx, table):
    """`table[idx]` as an exact one-hot matmul.

    The one-hot product is exact for integer-valued tables (0/1 weights,
    HIGHEST precision, one nonzero term per row).
    Shared by _palette_core_fn and _rdo_frame_body (trace-time only).
    Index counts that would materialize a >512 MB one-hot (the adaptive
    palettes reach E=2048 over ~330k blocks) run N-chunked."""
    import jax
    import jax.numpy as jnp

    k = table.shape[0]
    tf = table.astype(jnp.float32)

    def one(ix):
        oh = jax.nn.one_hot(ix, k, dtype=jnp.float32)
        return jnp.dot(
            oh, tf,
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32,
        )

    n = idx.shape[0]
    if n * k <= _ONEHOT_ELEM_BUDGET:
        return one(idx)
    chunk = max(128, (_ONEHOT_ELEM_BUDGET // k) // 128 * 128)
    pad = (-n) % chunk
    ixp = jnp.pad(idx, (0, pad))
    out = jax.lax.map(one, ixp.reshape(-1, chunk))
    return out.reshape(-1, table.shape[1])[:n]


def _seg_reduce(idx, k, x):
    """`sum_b one_hot(idx_b, k).T @ x_b` ([k, D]) with bounded memory.

    The direct [N, k] one-hot reaches 2+ GB at the adaptive palette
    sizes; chunking over N keeps the transient under the same budget as
    `_onehot_rows` (zero-padded rows map to segment 0 with zero values,
    so they contribute nothing)."""
    import jax
    import jax.numpy as jnp

    xf = x.astype(jnp.float32)

    def one(args):
        ix, xc = args
        oh = jax.nn.one_hot(ix, k, dtype=jnp.float32)
        # HIGHEST: the summed values (block errors, features) need full
        # f32; a TF32 product would round them to 10 mantissa bits
        return jnp.dot(
            oh.T, xc, preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )

    n = idx.shape[0]
    if n * k <= _ONEHOT_ELEM_BUDGET:
        return one((idx, xf))
    chunk = max(128, (_ONEHOT_ELEM_BUDGET // k) // 128 * 128)
    pad = (-n) % chunk
    ixp = jnp.pad(idx, (0, pad))
    xp = jnp.pad(xf, ((0, pad),) + ((0, 0),) * (xf.ndim - 1))
    parts = jax.lax.map(
        one, (ixp.reshape(-1, chunk), xp.reshape((-1, chunk) + xf.shape[1:]))
    )
    return jnp.sum(parts, axis=0)


def inten_block_errors(blocks, base_b):
    """Exact error of each block under each of the 8 intensity tables.

    blocks [N, 16, 3] f32, base_b [N, 3] f32 per-block base colors ->
    [N, 8] int32: per pixel the best of the table's 4 clip-aware codes,
    summed over the 16 pixels in int32 (exact)."""
    import jax
    import jax.numpy as jnp

    mods = jnp.asarray(INTEN_TABLES, jnp.float32)  # [8, 4]
    d = blocks - base_b[:, None, :]  # [N, 16, 3]
    err_cols = []
    for t in range(8):  # peak [N,16,4], not [N,16,8,4]
        me = (
            jnp.clip(base_b[:, None, :] + mods[t][None, :, None], 0.0, 255.0)
            - base_b[:, None, :]
        )  # [N, 4, 3]
        ce = jnp.sum(me**2, -1)[:, None, :] - 2.0 * jnp.einsum(
            "bpc,bjc->bpj", d, me,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )  # [N, 16, 4]
        err_cols.append(
            jnp.sum(jnp.min(ce, axis=-1).astype(jnp.int32), axis=1)
        )
    return jnp.stack(err_cols, axis=1)


def _palette_core_fn(
    num_endpoints: int,
    num_selectors: int,
    kmeans_iters: int,
    axis_name: str | None = None,
    gpu_kernel: bool = False,
    interpret: bool = False,
):
    """One fused XLA program for the entire palette build (per shape).

    `axis_name`: when set, the core runs as the per-device body of a
    `shard_map` over the block axis — every cross-block reduction
    (hierarchical-init segment sums, Lloyd centroid sums, cluster error
    matmuls, selector-codebook updates) gets a `psum` over that axis, and
    the strided spread samples come from a tiled `all_gather` so they see
    the global block order. Per-block phases (assignments, block_ce, the
    pair refinement) stay local — pure dp. Outputs: the codebooks are
    replicated (identical collectives on every device), the per-block
    assignments stay sharded.

    `gpu_kernel`: run the exact endpoint-assign stage as the fused
    Triton kernel (etc1s_assign.py; `interpret=True` runs it in the
    Pallas interpreter). The kernel and the XLA formulation both use
    EXACT INTEGER error accumulation, so they return identical
    assignments."""
    import jax
    import jax.numpy as jnp

    from uvol_tpu.codecs.basis import etc1s_assign
    from uvol_tpu.models.codebook import kmeans_assign, kmeans_update

    def feat_lloyd_iter(feats, cb):
        """One Lloyd iteration over the 4-D features (kmeans_update
        semantics: empty clusters keep their centroid)."""
        cb2, _ = kmeans_update(feats, cb, axis_name=axis_name)
        return cb2

    def gsum(x):
        """Global (cross-shard) reduction of a locally-reduced quantity."""
        return x if axis_name is None else jax.lax.psum(x, axis_name)

    def gathered(x):
        """Global view of a per-block array (original order; shards are
        contiguous axis-0 slices)."""
        if axis_name is None:
            return x
        return jax.lax.all_gather(x, axis_name, axis=0, tiled=True)

    def core(dev_blocks_u8):  # [N, 16, 3] uint8, cast to f32 on device
        # NOTE: all error matmuls below are pinned to HIGHEST (full f32)
        # precision — the operands (pixel sums up to 4080, effective
        # modifiers up to ±438) need more than bf16's 8 or TF32's 10
        # mantissa bits, and the error terms cancel pairs of
        # ~3e6-magnitude products, so reduced-precision products would
        # swamp real block-error differences.
        dev_blocks = dev_blocks_u8.astype(jnp.float32)
        n = dev_blocks.shape[0]
        means = jnp.mean(dev_blocks, axis=1)  # [N, 3]
        # contrast feature: std of the per-pixel gray deviation — blocks
        # with equal means but different contrast need different intensity
        # tables, so they must land in different endpoint clusters
        s_pix = jnp.sum(dev_blocks, axis=2) - jnp.sum(means, axis=1)[:, None]
        contrast = jnp.std(s_pix, axis=1) / 3.0  # [N]
        feats = jnp.concatenate([means, contrast[:, None]], axis=1)  # [N,4]

        # ---- endpoint clustering on (mean, contrast) features ----------------
        # init: hierarchical bisection (the shape of basisu's top-down
        # clusterizer): repeatedly split every cluster along its
        # highest-variance feature at the cluster mean, then Lloyd-refine.
        # One [N,k]x[N,9] one-hot product returns sums/sq-sums/counts in
        # one pass
        aug = jnp.concatenate(
            [feats, feats**2, jnp.ones((n, 1), jnp.float32)], axis=1
        )  # [N, 9]

        def seg_stats(assign_h, k):
            red = gsum(_seg_reduce(assign_h, k, aug))  # [k, 9]
            return red[:, :4], red[:, 4:8], red[:, 8]

        table_rows = _onehot_rows

        def hierarchical_init(e_target):
            import math

            rounds = max(1, math.ceil(math.log2(e_target)))
            assign_h = jnp.zeros(n, jnp.int32)
            k = 1
            for _ in range(rounds):
                sm, sq, cnt = seg_stats(assign_h, k)
                mean = sm / jnp.maximum(cnt, 1.0)[:, None]
                var = sq / jnp.maximum(cnt, 1.0)[:, None] - mean**2
                dim = jnp.argmax(var, axis=1)  # [k] split dimension
                thr = jnp.take_along_axis(mean, dim[:, None], 1)[:, 0]
                # [k,5] lookup rows: (dim==d) indicator + thr; one matmul
                # replaces the dim[assign_h]/thr[assign_h] gathers
                lut = jnp.concatenate(
                    [
                        jax.nn.one_hot(dim, 4, dtype=jnp.float32),
                        thr[:, None],
                    ],
                    axis=1,
                )
                look = table_rows(assign_h, lut)  # [N, 5]
                f_sel = jnp.sum(feats * look[:, :4], axis=1)
                assign_h = assign_h * 2 + (
                    f_sel > look[:, 4]
                ).astype(jnp.int32)
                k *= 2
            sm, _sq, cnt = seg_stats(assign_h, k)
            mean = sm / jnp.maximum(cnt, 1.0)[:, None]
            order = jnp.argsort(-cnt)[:e_target]  # heaviest leaves
            cb0 = mean[order]
            good = cnt[order] > 0
            feats_g = gathered(feats)
            n_g = feats_g.shape[0]
            spread = feats_g[:: max(1, n_g // e_target)][:e_target]
            return jnp.where(good[:, None], cb0, spread)

        cb = hierarchical_init(num_endpoints)
        for _ in range(kmeans_iters):
            cb = feat_lloyd_iter(feats, cb)
        base5 = jnp.clip(
            jnp.round(cb[:, :3] * 31.0 / 255.0), 0, 31
        ).astype(jnp.int32)
        base = (base5 << 3) | (base5 >> 2)  # [E, 3]

        # assignment: quantized base + the cluster's contrast feature (what
        # the decoder effectively reconstructs)
        cb_q = jnp.concatenate(
            [base.astype(jnp.float32), cb[:, 3:]], axis=1
        )
        assign = kmeans_assign(feats, cb_q)  # [N]
        mods = jnp.asarray(INTEN_TABLES, jnp.float32)  # [8, 4]

        # All error terms below are CLIP-AWARE: the reconstruction clamps
        # clip(base + modifier) per channel, so the effective modifier is
        # m_eff[j, c] = clip(base_c + m_j) - base_c. The earlier unclipped
        # 3m²-2ms shortcut overestimated error wherever base+mod saturates
        # — i.e. on every dark/bright region (liam's whole background) —
        # which distorted both assignment and the Lloyd update.

        # the kernel's pixel planes, built once for every exact_assign
        planes = (
            etc1s_assign.pixel_planes(dev_blocks_u8) if gpu_kernel else None
        )

        def cluster_inten(assign, basef):
            """Per-cluster best intensity table under the true error.

            Per-block errors are EXACT integers (int32-summed per-pixel
            minima); the cross-cluster reduction stays a float one-hot
            matmul (cluster sums exceed int32 range)."""
            base_b = table_rows(assign, basef)  # [N, 3] gather-free
            err_bt = inten_block_errors(dev_blocks, base_b).astype(
                jnp.float32
            )  # [N, 8]
            cluster_err = gsum(
                _seg_reduce(assign, num_endpoints, err_bt)
            )  # [E, 8]
            return jnp.argmin(cluster_err, axis=1).astype(jnp.int32)

        inten = cluster_inten(assign, base.astype(jnp.float32))

        # ---- exact-metric Lloyd refinement -----------------------------------
        # err(b, e) = Σ_pix min_j Σ_c (p_c - base_ec - m_eff[e,j,c])², with
        # m_eff the clip-aware effective modifier (etc1s_assign.py).
        p_sq = jnp.sum(dev_blocks.astype(jnp.float32) ** 2, axis=(1, 2))  # [N]
        p_sum = jnp.sum(dev_blocks, axis=1)  # [N, 3] per-channel pixel sums

        def exact_assign(basef, inten_idx):
            """argmin_e of the exact block error (integer accumulation)."""
            me_e, q_ej = etc1s_assign.effective_modifiers(
                basef, mods[inten_idx]
            )
            if gpu_kernel:
                return etc1s_assign.assign_endpoints_triton(
                    planes,
                    etc1s_assign.endpoint_const_rows(basef, me_e, q_ej),
                    n=n,
                    interpret=interpret,
                )
            return etc1s_assign.assign_endpoints_xla(
                dev_blocks, basef, me_e, q_ej
            )

        def block_ce(basef, inten_idx, assign):
            """Per-block per-pixel per-code error (clip-aware, + const).

            Returns (ce [N,16,4], me_b [N,4,3]) — the shared tensor behind
            ideal selectors, the Lloyd update, and both selector-codebook
            stages."""
            # base color + intensity row per block in ONE one-hot matmul
            lut = jnp.concatenate(
                [basef, mods[inten_idx]], axis=1
            )  # [E, 7]
            look = table_rows(assign, lut)
            base_b = look[:, :3]  # [N, 3]
            me_b = (
                jnp.clip(
                    base_b[:, None, :] + look[:, 3:][:, :, None],
                    0.0,
                    255.0,
                )
                - base_b[:, None, :]
            )  # [N, 4, 3]
            d = dev_blocks - base_b[:, None, :]  # [N, 16, 3]
            # broadcast-multiply form: exact integers, and it fuses as one
            # elementwise pass
            ce = jnp.sum(me_b**2, -1)[:, None, :] - 2.0 * jnp.sum(
                d[:, :, None, :] * me_b[:, None, :, :], axis=-1
            )  # [N, 16, 4]
            return ce, me_b

        for _ in range(2):  # Lloyd iterations on the true metric
            basef = base.astype(jnp.float32)
            assign = exact_assign(basef, inten)
            # base update: mean over member pixels of (p - chosen modifier)
            ce, me_b = block_ce(basef, inten, assign)
            sel_px = jnp.argmin(ce, axis=-1)  # [N, 16]
            # 4-way arithmetic select in place of take_along_axis; exact
            # (0/1 weights on integer modifiers)
            me_px = sum(
                jnp.where(
                    (sel_px == j)[:, :, None], me_b[:, None, j, :], 0.0
                )
                for j in range(4)
            )  # [N, 16, 3]
            resid = dev_blocks - me_px
            red = gsum(
                _seg_reduce(
                    assign,
                    num_endpoints,
                    jnp.concatenate(
                        [
                            jnp.mean(resid, axis=1),
                            jnp.ones((n, 1), jnp.float32),
                        ],
                        axis=1,
                    ),
                )
            )  # [E, 4]: per-cluster residual-mean sums ++ counts
            sums, counts = red[:, :3], red[:, 3]
            new_mean = jnp.where(
                counts[:, None] > 0,
                sums / jnp.maximum(counts, 1.0)[:, None],
                basef,
            )
            base5 = jnp.clip(jnp.round(new_mean * 31.0 / 255.0), 0, 31).astype(
                jnp.int32
            )
            base = (base5 << 3) | (base5 >> 2)
            inten = cluster_inten(assign, base.astype(jnp.float32))
        assign = exact_assign(base.astype(jnp.float32), inten)
        ce, _me_b = block_ce(base.astype(jnp.float32), inten, assign)

        # ---- ideal per-pixel selectors ---------------------------------------
        ideal_sel = jnp.argmin(ce, axis=-1).astype(jnp.int32)  # [N, 16]

        # ---- selector codebook: Lloyd in the TRUE (clip-aware) metric ---------
        # `ce` already holds each block's per-pixel per-code error, so both
        # stages are one-hot matmuls:
        #   assignment: err[b, k] = Σ_p ce[b, p, cb[k, p]]
        #   update:     cb[k, p] = argmin_j Σ_{b∈k} ce[b, p, j]
        def sel_exact_assign(sel_cb):
            oh_cb = jax.nn.one_hot(sel_cb, 4, dtype=jnp.float32)  # [S, 16, 4]
            cbT = oh_cb.reshape(num_selectors, 64).T  # [64, S]
            ce64 = ce.reshape(n, 64)

            def one(ce_c):
                # HIGHEST: block error sums reach ~1e7, far past TF32's
                # 10-bit mantissa
                err_ks = jnp.dot(
                    ce_c, cbT, preferred_element_type=jnp.float32,
                    precision=jax.lax.Precision.HIGHEST,
                )
                return jnp.argmin(err_ks, axis=1).astype(jnp.int32)

            if n * num_selectors <= _ONEHOT_ELEM_BUDGET:
                return one(ce64)  # [N]
            chunk = max(
                128, (_ONEHOT_ELEM_BUDGET // num_selectors) // 128 * 128
            )
            pad = (-n) % chunk
            cep = jnp.pad(ce64, ((0, pad), (0, 0)))
            return jax.lax.map(
                one, cep.reshape(-1, chunk, 64)
            ).reshape(-1)[:n]

        def sel_update(sel_assign):
            c_kpj = gsum(
                _seg_reduce(sel_assign, num_selectors, ce.reshape(n, 64))
            ).reshape(num_selectors, 16, 4)
            return jnp.argmin(c_kpj, axis=-1).astype(jnp.int32)  # [S, 16]

        # selector codebook init: same hierarchical bisection, over the
        # ideal per-pixel code patterns (16-D in {0..3})
        def sel_hierarchical_init(s_target):
            import math

            rounds = max(1, math.ceil(math.log2(s_target)))
            featsS = ideal_sel.astype(jnp.float32)  # [N, 16]
            # stats via one-hot matmuls (scatter-free, like the endpoint
            # init): one [N,k]x[N,33] product per round
            augS = jnp.concatenate(
                [featsS, featsS**2, jnp.ones((n, 1), jnp.float32)], axis=1
            )  # [N, 33]

            def seg_statsS(assign_h, k):
                red = gsum(_seg_reduce(assign_h, k, augS))  # [k, 33]
                return red[:, :16], red[:, 16:32], red[:, 32]

            assign_h = jnp.zeros(n, jnp.int32)
            k = 1
            for _ in range(rounds):
                sm, sq, cnt = seg_statsS(assign_h, k)
                mean = sm / jnp.maximum(cnt, 1.0)[:, None]
                var = sq / jnp.maximum(cnt, 1.0)[:, None] - mean**2
                dim = jnp.argmax(var, axis=1)
                thr = jnp.take_along_axis(mean, dim[:, None], 1)[:, 0]
                lut = jnp.concatenate(
                    [
                        jax.nn.one_hot(dim, 16, dtype=jnp.float32),
                        thr[:, None],
                    ],
                    axis=1,
                )  # [k, 17]
                look = table_rows(assign_h, lut)
                f_sel = jnp.sum(featsS * look[:, :16], axis=1)
                assign_h = assign_h * 2 + (
                    f_sel > look[:, 16]
                ).astype(jnp.int32)
                k *= 2
            sm, _sq, cnt = seg_statsS(assign_h, k)
            mean = sm / jnp.maximum(cnt, 1.0)[:, None]
            order = jnp.argsort(-cnt)[:s_target]
            cb0 = jnp.clip(jnp.round(mean[order]), 0, 3).astype(jnp.int32)
            good = cnt[order] > 0
            sel_g = gathered(ideal_sel)
            n_g = sel_g.shape[0]
            spread = sel_g[:: max(1, n_g // s_target)][:s_target]
            return jnp.where(good[:, None], cb0, spread)

        sel_cb = sel_hierarchical_init(num_selectors)
        sel_assign = sel_exact_assign(sel_cb)
        for _ in range(max(2, kmeans_iters // 2)):
            sel_cb = sel_update(sel_assign)
            sel_assign = sel_exact_assign(sel_cb)

        # ---- joint refinement: pair-accurate endpoint re-assignment ----------
        # With each block's CODEBOOK selector fixed, the exact error against
        # every endpoint collapses into two matmuls:
        #   err[b,e] = Σd² + Σ_j cnt[b,j]·q[e,j] − 2·Σ_j G[b,j,:]·me[e,j,:]
        # where G sums block pixels by their selector code. Then re-pick the
        # selector under the new endpoint; one alternation converges most of
        # the way (basisu iterates its codebooks similarly).
        basef = base.astype(jnp.float32)
        me_e = (
            jnp.clip(basef[:, None, :] + mods[inten][:, :, None], 0.0, 255.0)
            - basef[:, None, :]
        )  # [E, 4, 3]
        q_ej = 2.0 * jnp.einsum(
            "ec,ejc->ej", basef, me_e,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        ) + jnp.sum(me_e**2, -1)  # [E, 4]
        base_sq = 16.0 * jnp.sum(basef**2, axis=1)
        codes_b = sel_cb[sel_assign]  # [N, 16]
        oh_codes = jax.nn.one_hot(codes_b, 4, dtype=jnp.float32)  # [N,16,4]
        g_bjc = jnp.einsum(
            "bpc,bpj->bjc", dev_blocks, oh_codes,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )  # [N, 4, 3]
        cnt_bj = jnp.sum(oh_codes, axis=1)  # [N, 4]

        # chunk over blocks: the [N, E] error tile stays ~200 MB
        bchunk = 32768
        n_b = (n + bchunk - 1) // bchunk
        pad_b = n_b * bchunk - n

        def _pad0(a):
            return jnp.pad(a, ((0, pad_b),) + ((0, 0),) * (a.ndim - 1))

        def pair_chunk(xs):
            g_c, cnt_c, psq_c, psum_c = xs
            p2 = jnp.einsum(
                "bjc,ejc->be", g_c, me_e,
                preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST,
            )
            q2 = jnp.dot(
                cnt_c, q_ej.T, preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST,
            )
            cross = jnp.dot(
                psum_c, basef.T, preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST,
            )
            err = psq_c[:, None] - 2.0 * cross + base_sq[None] + q2 - 2.0 * p2
            return jnp.argmin(err, axis=1).astype(jnp.int32)

        assign = jax.lax.map(
            pair_chunk,
            (
                _pad0(g_bjc).reshape(n_b, bchunk, 4, 3),
                _pad0(cnt_bj).reshape(n_b, bchunk, 4),
                _pad0(p_sq).reshape(n_b, bchunk),
                _pad0(p_sum).reshape(n_b, bchunk, 3),
            ),
        ).reshape(-1)[:n]
        # selector re-pick under the refined endpoints
        ce, _ = block_ce(basef, inten, assign)
        sel_assign = sel_exact_assign(sel_cb)

        # narrow the big per-block outputs to uint8 whenever the palettes
        # fit: a quarter of the device-to-host bytes
        if num_endpoints <= 256 and num_selectors <= 256:
            assign = assign.astype(jnp.uint8)
            sel_assign = sel_assign.astype(jnp.uint8)
        return base5, inten, sel_cb, assign, sel_assign

    return core


def build_palettes(
    frames: np.ndarray,
    num_endpoints: int,
    num_selectors: int,
    kmeans_iters: int = 6,
    *,
    rdo: bool = True,
    rdo_chain_breaks: Sequence[int] = (),
    rdo_lambdas: Tuple[float, float, float] = (1.25, 1.5, 1.5),
    delta_window: int = 0,
    delta_lambda: float = 60.0,
    mesh: Optional["object"] = None,
) -> Palettes:
    """Global palettes + per-block assignments, one jitted device program.

    frames: [F, H, W, 3] uint8.

    `mesh`: a `jax.sharding.Mesh` with a `frames` axis — the block axis
    is then sharded over the mesh via `shard_map` with psum/all_gather
    collectives inside the core (the production form of the reference's
    per-segment worker-pool parallelism, SURVEY §2.4). Assignments are
    bit-exact per block; the shared codebooks can differ from the
    single-device build in float-sum order only (cross-shard psum vs
    one-device segment-sum), so the contract is quality parity, not
    byte identity (asserted by tests/test_multichip.py). Block counts
    not divisible by the mesh size fall back to single-device."""
    f, h, w, _ = frames.shape
    nb = (h // 4) * (w // 4)
    blocks = np.ascontiguousarray(
        frames.reshape(f, h // 4, 4, w // 4, 4, 3)
        .transpose(0, 1, 3, 2, 4, 5)
        .reshape(f * nb, 16, 3)
    )  # uint8; cast to f32 on device (4x smaller upload)
    n = blocks.shape[0]
    num_endpoints = min(num_endpoints, n)
    num_selectors = min(num_selectors, n)

    from uvol_tpu.parallel.mesh import FRAME_AXIS

    if mesh is not None and n % mesh.shape[FRAME_AXIS] != 0:
        import warnings

        warnings.warn(
            f"build_palettes: {n} blocks not divisible by the "
            f"{mesh.shape[FRAME_AXIS]}-device frame axis; "
            "running single-device",
            RuntimeWarning,
        )
        mesh = None

    import jax

    from uvol_tpu.codecs.basis.etc1s_assign import use_gpu_kernel

    # one blocks upload for the whole segment: the k-means core and the
    # RDO scan below share this device-resident uint8 array
    dev_blocks = jax.device_put(blocks)
    # the endpoint-assign stage runs as the Triton kernel where the blocks
    # live on a GPU, as XLA elsewhere. Its errors are exact integers on
    # both paths; the feature-space Lloyd steps use bf16 dots whose
    # rounding differs between backends, so cross-backend output is
    # quality parity, not byte identity (each backend is deterministic on
    # its own — the same contract as the mesh-sharded build)
    platform = (
        mesh.devices.flat[0] if mesh is not None
        else next(iter(dev_blocks.devices()))
    ).platform
    gpu_kernel = use_gpu_kernel(platform)
    key = (num_endpoints, num_selectors, kmeans_iters, mesh, gpu_kernel)
    core = _PALETTE_JIT_CACHE.get(key)
    if core is None:
        if mesh is None:
            core = jax.jit(
                _palette_core_fn(
                    num_endpoints, num_selectors, kmeans_iters,
                    gpu_kernel=gpu_kernel,
                )
            )
        else:
            from jax.sharding import PartitionSpec as P

            body = _palette_core_fn(
                num_endpoints, num_selectors, kmeans_iters,
                axis_name=FRAME_AXIS,
                gpu_kernel=gpu_kernel,
            )
            spec = P(FRAME_AXIS)
            core = jax.jit(
                jax.shard_map(
                    body, mesh=mesh, in_specs=(spec,),
                    # codebooks replicated (identical collectives on every
                    # device); per-block assignments stay sharded
                    out_specs=(P(), P(), P(), spec, spec),
                    check_vma=False,
                )
            )
        _PALETTE_JIT_CACHE[key] = core
    import jax.numpy as jnp

    base5, inten, sel_cb, assign, sel_assign = core(dev_blocks)

    # delta-aware path: only meaningful with the larger adaptive
    # palettes, where the chain relabel below exposes real successor
    # structure (PERF.md §8: at E=256 near-optimal entries are scattered)
    use_delta_bias = delta_window > 0 and num_endpoints >= 512

    if rdo:
        # the refine below overwrites both assignment grids from the
        # device-resident copies — placeholders here skip two dead
        # [F, NB] device->host fetches per segment
        pal = Palettes(
            color5=np.array(np.asarray(base5, np.uint8)),
            inten=np.array(np.asarray(inten, np.uint8)),
            selectors=np.asarray(sel_cb, np.uint8),
            block_endpoint=np.empty((f, nb), np.int32),
            block_selector=np.empty((f, nb), np.int32),
        )
        lam, lam_sel, lam_cr = rdo_lambdas
        rdo_refine_assignments(
            blocks, pal, h // 4, w // 4,
            lam=lam, lam_sel=lam_sel, lam_cr=lam_cr,
            chain_breaks=rdo_chain_breaks,
            dev_blocks=dev_blocks,
            dev_assign=jnp.asarray(assign, jnp.int32),
            dev_sel_assign=jnp.asarray(sel_assign, jnp.int32),
        )
    else:
        pal = Palettes(
            color5=np.array(np.asarray(base5, np.uint8)),
            inten=np.array(np.asarray(inten, np.uint8)),
            selectors=np.asarray(sel_cb, np.uint8),
            block_endpoint=np.array(
                np.asarray(assign, np.int32).reshape(f, nb)
            ),
            block_selector=np.array(
                np.asarray(sel_assign, np.int32).reshape(f, nb)
            ),
        )
    # relabel the endpoint palette along the directed scan-successor
    # chains: the dominant transitions become +1 deltas (the ordering
    # structure basisu's own files exhibit)
    reorder_endpoint_palette(pal)
    if use_delta_bias:
        # endpoint-major flips (uniform-selector + fine-endpoint coding,
        # the structure basisu's files show on hard content) ...
        delta_bias_assignments(
            pal, h // 4, w // 4,
            dev_blocks=dev_blocks,
            # flips trade ~9 bits (sel symbol + delta concentration) per
            # block, sweeps ~1-3: the flip gate runs hotter (seg-5
            # matrix: flip 2.5x/sweep 1x was the best operating point)
            lam_bits=2.5 * delta_lambda,
            lam_cr=rdo_lambdas[2],
            chain_breaks=rdo_chain_breaks,
        )
        # ... then alternate chain relabels with full-palette
        # rate-distortion endpoint argmins (delta bits priced in chain
        # space), concentrating the delta stream on {LEFT, +1}
        # (monotone through 3 Gauss-Seidel rounds on the seg-5 study)
        for _ in range(3):
            reorder_endpoint_palette(pal)
            rate_sweep_assignments(
                pal, h // 4, w // 4,
                dev_blocks=dev_blocks,
                lam_bits=delta_lambda,
                lam_cr=rdo_lambdas[2],
                chain_breaks=rdo_chain_breaks,
            )
        reorder_endpoint_palette(pal)
    return pal


def _delta_entropy_proxy(block_endpoint: np.ndarray, e_n: int) -> float:
    """Mean bits/explicit-block of the scan-order endpoint delta stream
    (empirical entropy of (ep - prev) mod E over blocks that differ from
    their left neighbor) — the quantity the slice Huffman table prices."""
    a = block_endpoint[:, 1:].reshape(-1)
    l = block_endpoint[:, :-1].reshape(-1)
    m = a != l
    if not m.any():
        return 0.0
    d = (a[m].astype(np.int64) - l[m]) % e_n
    cnt = np.bincount(d, minlength=e_n).astype(np.float64)
    p = cnt[cnt > 0] / cnt.sum()
    return float(-(p * np.log2(p)).sum())


def reorder_endpoint_palette(pal: "Palettes") -> None:
    """In-place palette relabel concentrating scan-order deltas on +1.

    The slice format codes an explicit endpoint as a Huffman delta
    against the previous block's index, so the permutation that matters
    is the one that maps each entry's most frequent scan SUCCESSOR to
    index+1. basisu's files show exactly this structure (seg 5: 54% of
    transition mass on the per-source top successor, and 56% of its
    emitted deltas are literally +1 — whole scan rows walk consecutive
    palette indices). This is the maximum-weight Hamiltonian-path
    greedy on the DIRECTED transition multigraph: take edges by weight,
    each node gets at most one successor and one predecessor, reject
    cycles (union-find), then label along the resulting chains. The
    earlier tail-extension greedy on the SYMMETRIZED graph captured
    almost none of this (PERF.md §8's negative reorder results — the
    direction and the edge-global greedy are both load-bearing)."""
    e = len(pal.color5)
    if e <= 2:
        return
    ep = pal.block_endpoint
    a = ep[:, :-1].reshape(-1).astype(np.int64)
    b = ep[:, 1:].reshape(-1).astype(np.int64)
    m = a != b
    pair, wgt = np.unique(a[m] * e + b[m], return_counts=True)
    src = (pair // e).astype(np.int64)
    dst = (pair % e).astype(np.int64)
    order_w = np.argsort(-wgt, kind="stable")
    nxt = np.full(e, -1, np.int64)
    has_pred = np.zeros(e, bool)
    parent = np.arange(e, dtype=np.int64)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for k in order_w:
        s, t = src[k], dst[k]
        if s == t or nxt[s] >= 0 or has_pred[t]:
            continue
        rs, rt = find(s), find(t)
        if rs == rt:
            continue  # would close a cycle
        nxt[s] = t
        has_pred[t] = True
        parent[rs] = rt
    # label along chains, heads first (nodes with no predecessor)
    order = np.empty(e, np.int64)
    pos = 0
    for h in range(e):
        if has_pred[h]:
            continue
        c = h
        while c >= 0:
            order[pos] = c
            pos += 1
            c = nxt[c]
    assert pos == e
    inv = np.empty(e, np.int32)
    inv[order] = np.arange(e, dtype=np.int32)
    pal.color5 = pal.color5[order]
    pal.inten = pal.inten[order]
    pal.block_endpoint = inv[pal.block_endpoint]


_RDO_JIT_CACHE: Dict = {}


def _rdo_refine_fn(nby: int, nbx: int):
    """Rate-distortion refine across all frames as ONE device program.

    Returns a jitted fn scanning `_rdo_frame_body` over the frame axis:
    blocks stay device-resident uint8 (one upload for the whole segment,
    cast to f32 per scan step), the CR chain state rides the scan carry,
    and the refined assignments come back as one [F, nb] fetch instead of
    a per-frame upload/dispatch/download loop.
    """
    import jax
    import jax.numpy as jnp

    body = _rdo_frame_body(nby, nbx)

    def run(blocks_u8, color5, inten, sel_cb, assigns, sel_assigns,
            is_break, lam, lam_sel, lam_cr):
        # blocks_u8 [F, nb, 16, 3] · assigns/sel_assigns [F, nb] ·
        # is_break [F] bool (True = I-slice: no CR against prev frame)
        nb = assigns.shape[1]

        def step(carry, xs):
            prev_ep, prev_sel, has_prev = carry
            blocks_i, assign_i, sel_i, brk = xs
            ep, sel = body(
                blocks_i.astype(jnp.float32), color5, inten, sel_cb,
                assign_i, sel_i, prev_ep, prev_sel,
                jnp.broadcast_to(has_prev & ~brk, (nb,)),
                lam, lam_sel, lam_cr,
            )
            return (ep, sel, jnp.bool_(True)), (ep, sel)

        init = (
            jnp.zeros(nb, jnp.int32),
            jnp.zeros(nb, jnp.int32),
            jnp.bool_(False),
        )
        _, (eps, sels) = jax.lax.scan(
            step, init, (blocks_u8, assigns, sel_assigns, is_break)
        )
        # narrow the fetch: indices fit uint8 for palettes <= 256
        if color5.shape[0] <= 256 and sel_cb.shape[0] <= 256:
            return eps.astype(jnp.uint8), sels.astype(jnp.uint8)
        return eps, sels

    return jax.jit(run)


def _rdo_frame_body(nby: int, nbx: int):
    """Rate-distortion refine for one frame's assignments.

    Snaps a block's endpoint to its left/above neighbor's (and, on
    P-frames, to the co-located previous-frame (endpoint, selector) pair)
    whenever the squared-error increase stays within a lambda factor.
    Spatially coherent assignments turn into LEFT/ABOVE predictions,
    endpoint-delta runs, selector RLE runs and CR blocks — the rate side
    of basisu's RDO — while lambda bounds the distortion side.
    """
    import jax.numpy as jnp

    from uvol_tpu.codecs.basis.transcoder import INTEN_TABLES

    inten_tab = jnp.asarray(INTEN_TABLES, jnp.float32)  # [8, 4]

    def refine(blocks, color5, inten, sel_cb, assign, sel_assign,
               prev_ep, prev_sel, has_prev, lam, lam_sel, lam_cr):
        # blocks [N,16,3] f32 · color5 [E,3] · inten [E] · sel_cb [S,16]
        base = (
            (color5.astype(jnp.int32) << 3) | (color5.astype(jnp.int32) >> 2)
        ).astype(jnp.float32)  # [E, 3] extended

        # per-endpoint lookup rows (base color ++ intensity modifiers) and
        # the selector codebook, fetched via exact one-hot matmuls (refine
        # makes ~10 three-lookup error evaluations per frame)
        ep_lut = jnp.concatenate(
            [base, inten_tab[inten]], axis=1
        )  # [E, 7]
        rows = _onehot_rows

        def pair_err(ep_idx, sel_idx):
            """Exact error of coding each block with (ep, sel)."""
            look = rows(ep_idx, ep_lut)            # [N, 7]
            b = look[:, :3]                        # [N, 3]
            m = look[:, 3:]                        # [N, 4]
            codes = rows(sel_idx, sel_cb)          # [N, 16] integer-valued
            # 4-way arithmetic select replaces take_along_axis (gather)
            mod = sum(
                jnp.where(codes == j, m[:, j : j + 1], 0.0) for j in range(4)
            )  # [N, 16]
            cand = jnp.clip(b[:, None, :] + mod[:, :, None], 0.0, 255.0)
            d = blocks - cand
            return jnp.sum(d * d, axis=(1, 2))     # [N]

        grid = lambda a: a.reshape(nby, nbx)  # noqa: E731
        flat = lambda a: a.reshape(-1)  # noqa: E731

        ep = assign
        sel = sel_assign
        for _ in range(2):  # second pass propagates runs
            g = grid(ep)
            left = flat(jnp.concatenate([g[:, :1], g[:, :-1]], axis=1))
            above = flat(jnp.concatenate([g[:1, :], g[:-1, :]], axis=0))
            e_self = pair_err(ep, sel)
            e_left = pair_err(left, sel)
            e_above = pair_err(above, sel)
            slack = 16.0 * 4.0  # absolute headroom on near-zero errors
            ep = jnp.where(
                e_left <= lam * e_self + slack,
                left,
                jnp.where(e_above <= lam * e_self + slack, above, ep),
            )
        # selector smoothing: adopt the left neighbor's selector when the
        # pair error stays close — creates the RLE runs the format rewards
        gs = grid(sel)
        sel_left = flat(jnp.concatenate([gs[:, :1], gs[:, :-1]], axis=1))
        e_cur = pair_err(ep, sel)
        e_sl = pair_err(ep, sel_left)
        sel = jnp.where(e_sl <= lam_sel * e_cur + 16.0 * 4.0, sel_left, sel)

        # conditional replenishment: copy the co-located previous-frame
        # pair when its error is close to the refined choice's
        e_ref = pair_err(ep, sel)
        e_prev = pair_err(prev_ep, prev_sel)
        cr = has_prev & (e_prev <= lam_cr * e_ref + 16.0 * 4.0)
        ep = jnp.where(cr, prev_ep, ep)
        sel = jnp.where(cr, prev_sel, sel)
        return ep, sel

    return refine


_DELTA_BIAS_JIT_CACHE: Dict[Tuple, object] = {}


def _endpoint_major_fn(nby: int, nbx: int, num_endpoints: int,
                       num_selectors: int, s0_index: int, s0_code: int):
    """Endpoint-major refine: uniform-selector + fine-endpoint coding.

    Structure read directly out of basisu's own files (seg 5 of the
    liam corpus): 85% of its blocks use ONE all-`code` uniform selector
    — every such block decodes to a single flat color — while the
    block's information lives in a fine-grained endpoint palette whose
    indices count upward along scan runs (56% of its explicit deltas
    are literally +1). Our selector-major assignment (rich per-block
    selectors over a coarse palette) priced every stream ~2x basisu's.

    This pass offers every block the endpoint-major coding and takes it
    when the rate-distortion gate favors it:

      err0(b) = min_e  Σ_px |p_px − clip(base_e + m_e[s0_code])|²

    which is a single [NB,3]x[3,E] matmul per frame (the uniform
    selector turns the candidate into one flat color per endpoint).
    Flipped blocks join the uniform-selector RLE runs (sel stream
    ~free) and their fine-endpoint indices chain into +1 deltas after
    reorder_endpoint_palette. A conditional-replenishment snap runs
    last so the temporal chain survives."""
    import jax
    import jax.numpy as jnp

    from uvol_tpu.codecs.basis.transcoder import INTEN_TABLES

    inten_tab = jnp.asarray(INTEN_TABLES, jnp.float32)
    nb = nby * nbx

    def frame_body(blocks, ep_lut, sel_cb, ep, sel,
                   prev_ep, prev_sel, has_prev, lam_bits, lam_cr):
        rows = _onehot_rows
        slack = 16.0 * 4.0

        def err_with_codes(look, codes):
            b3 = look[:, :3]
            m = look[:, 3:]
            mod = sum(
                jnp.where(codes == j, m[:, j : j + 1], 0.0) for j in range(4)
            )
            cand = jnp.clip(b3[:, None, :] + mod[:, :, None], 0.0, 255.0)
            d = blocks - cand
            return jnp.sum(d * d, axis=(1, 2))  # [nb]

        # flat-color palette: every endpoint under the uniform selector
        col = jnp.clip(
            ep_lut[:, :3] + ep_lut[:, 3 + s0_code : 4 + s0_code], 0.0, 255.0
        )  # [E, 3]
        p_sq = jnp.sum(blocks * blocks, axis=(1, 2))  # [nb]
        p_sum = jnp.sum(blocks, axis=1)  # [nb, 3]
        err_e = (
            p_sq[:, None]
            - 2.0
            * jnp.dot(
                p_sum, col.T,
                precision=jax.lax.Precision.HIGHEST,
                preferred_element_type=jnp.float32,
            )
            + 16.0 * jnp.sum(col * col, axis=1)[None, :]
        )  # [nb, E]
        ep0 = jnp.argmin(err_e, axis=1).astype(jnp.int32)
        err0 = jnp.min(err_e, axis=1)

        codes_cur = rows(sel, sel_cb)
        e_cur = err_with_codes(rows(ep, ep_lut), codes_cur)
        # bits saved by joining the uniform-selector run + chained
        # endpoint deltas: ~6 (sel symbol) + ~3 (delta concentration)
        flip = err0 <= e_cur + lam_bits * 9.0
        ep = jnp.where(flip, ep0, ep)
        sel = jnp.where(flip, jnp.int32(s0_index), sel)

        # conditional replenishment against the previous slice
        codes_new = rows(sel, sel_cb)
        e_new = err_with_codes(rows(ep, ep_lut), codes_new)
        codes_prev = rows(prev_sel, sel_cb)
        e_prev = err_with_codes(rows(prev_ep, ep_lut), codes_prev)
        cr = has_prev & (e_prev <= lam_cr * e_new + slack)
        ep = jnp.where(cr, prev_ep, ep)
        sel = jnp.where(cr, prev_sel, sel)
        return ep, sel

    def run(blocks_u8, color5, inten, sel_cb, assigns, sel_assigns,
            is_break, lam_bits, lam_cr):
        base = (
            (color5.astype(jnp.int32) << 3) | (color5.astype(jnp.int32) >> 2)
        ).astype(jnp.float32)
        ep_lut = jnp.concatenate([base, inten_tab[inten]], axis=1)  # [E,7]

        def step(carry, xs):
            prev_ep, prev_sel, has_prev = carry
            blocks_i, assign_i, sel_i, brk = xs
            ep, sel = frame_body(
                blocks_i.astype(jnp.float32), ep_lut, sel_cb,
                assign_i, sel_i, prev_ep, prev_sel,
                jnp.broadcast_to(has_prev & ~brk, (nb,)),
                lam_bits, lam_cr,
            )
            return (ep, sel, jnp.bool_(True)), (ep, sel)

        init = (
            jnp.zeros(nb, jnp.int32),
            jnp.zeros(nb, jnp.int32),
            jnp.bool_(False),
        )
        _, (eps, sels) = jax.lax.scan(
            step, init, (blocks_u8, assigns, sel_assigns, is_break)
        )
        return eps, sels

    return jax.jit(run)


def _rate_sweep_fn(nby: int, nbx: int, num_endpoints: int,
                   num_selectors: int, s0_index: int, s0_code: int):
    """Rate-distortion endpoint argmin for EVERY block (round 5).

    r4's sweep re-picked only uniform-selector blocks; patterned blocks
    kept their pair and got a CR snap — which is exactly why our scan-
    transition concentration stalled at 0.31 vs basisu's 0.54 (PERF §9):
    the patterned half of the grid never participated in run building.
    This pass prices the FULL palette for every block under its CURRENT
    selector codes via an exact decomposition — grouping a block's
    pixels by their 2-bit code c,

        err(b,e) = p_sq(b) − 2·Σ_c S_c(b)·col(e,c) + Σ_c n_c(b)·|col(e,c)|²

    with S_c the per-code pixel sums, n_c the per-code counts and
    col(e,c) the clipped decoded color — one [nb,16]×[16,E] matmul
    per frame instead of a [nb,E,16,3] tensor (for uniform-selector
    blocks this reduces to r4's flat-color form exactly). The wire
    price of entry e given the left neighbor's FINAL entry L stays the
    chain-space bits model (0 → LEFT, +1 → successor, else a log-shaped
    explicit delta); matching the ABOVE neighbor's incoming entry is
    additionally offered at the pred-symbol price — ABOVE costs no
    delta bits and r4's sweep never priced it. Gauss-Seidel over
    columns as before; CR competes inside the same objective."""
    import jax
    import jax.numpy as jnp

    from uvol_tpu.codecs.basis.transcoder import INTEN_TABLES

    inten_tab = jnp.asarray(INTEN_TABLES, jnp.float32)
    nb = nby * nbx
    e_n = num_endpoints

    def frame_body(blocks, ep_lut, sel_cb, ep, sel,
                   prev_ep, prev_sel, has_prev, lam_bits, lam_cr):
        rows = _onehot_rows
        slack = 16.0 * 4.0

        def err_with_codes(look, codes):
            b3 = look[:, :3]
            m = look[:, 3:]
            mod = sum(
                jnp.where(codes == j, m[:, j : j + 1], 0.0) for j in range(4)
            )
            cand = jnp.clip(b3[:, None, :] + mod[:, :, None], 0.0, 255.0)
            d = blocks - cand
            return jnp.sum(d * d, axis=(1, 2))

        # full-palette error under each block's OWN selector codes:
        # feat[b] = [-2·S_0..S_3 (12), n_0..n_3 (4)],
        # mat[e]  = [col(e,0..3)   (12), |col(e,c)|² (4)]
        col = jnp.clip(
            ep_lut[:, None, :3] + ep_lut[:, 3:, None], 0.0, 255.0
        )  # [E, 4, 3]
        mat = jnp.concatenate(
            [col.reshape(e_n, 12), jnp.sum(col * col, axis=2)], axis=1
        )  # [E, 16]
        codes_own = rows(sel, sel_cb)  # [nb, 16] integer-valued f32
        # per-code pixel sums / counts as 4 masked reductions (a
        # batched [nb,4,16]x[nb,16,3] einsum lowers to 65k tiny matmuls)
        s_parts, n_parts = [], []
        for j in range(4):
            m = (codes_own == j).astype(jnp.float32)  # [nb, 16]
            s_parts.append(jnp.sum(m[:, :, None] * blocks, axis=1))
            n_parts.append(jnp.sum(m, axis=1))
        S = jnp.concatenate(s_parts, axis=1)  # [nb, 12] (c-major)
        ncnt = jnp.stack(n_parts, axis=1)  # [nb, 4]
        p_sq = jnp.sum(blocks * blocks, axis=(1, 2))
        feat = jnp.concatenate([-2.0 * S, ncnt], axis=1)
        err_e = p_sq[:, None] + jnp.dot(
            feat, mat.T,
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32,
        )  # [nb, E]

        codes_prev = rows(prev_sel, sel_cb)
        e_prev = err_with_codes(rows(prev_ep, ep_lut), codes_prev)
        is_flat = sel == s0_index

        # ---- Gauss-Seidel over COLUMNS ----------------------------------
        # Every block's delta is priced against its LEFT neighbor, so a
        # Jacobi sweep (all blocks at once) prices against STALE
        # neighbors and breaks the very runs it is trying to build
        # (measured: !=left rose 0.81 -> 0.85). Scanning column-by-
        # column makes each column decide against the FINAL previous
        # column — exact for the left dependency — while the nby rows
        # stay data-parallel.
        iota_e = jnp.arange(e_n, dtype=jnp.int32)[None, :]  # [1, E]

        def col_step(carry, xs):
            left_idx = carry  # [nby] final choices of column c-1
            err_c, eprev_c, pe_c, ep_c, hp_c = xs
            dm = (iota_e - left_idx[:, None]) % e_n  # [nby, E]
            dsig = jnp.minimum(dm, e_n - dm).astype(jnp.float32)
            bits = jnp.where(
                dm == 0,
                1.2,
                jnp.where(
                    dm == 1,
                    2.0,
                    5.0
                    + 1.5 * jnp.log2(1.0 + dsig)
                    + 0.5 * (dm > e_n // 2),
                ),
            )
            # ABOVE prediction: matching the row-above block's incoming
            # entry costs only its share of the pred quad — no delta.
            # The above value is this sweep's INCOMING assignment (the
            # row above is decided concurrently in this column step);
            # each Gauss-Seidel round refreshes it.
            ab = jnp.concatenate([ep_c[:1], ep_c[:-1]])  # [nby]
            bits = jnp.where(
                iota_e == ab[:, None], jnp.minimum(bits, 1.4), bits
            )
            cost = err_c + lam_bits * bits
            ep_rd = jnp.argmin(cost, axis=1).astype(jnp.int32)
            cost_rd = jnp.min(cost, axis=1)
            # CR competes inside the same objective (~0.5 bits): breaking
            # a surviving temporal pair for a slightly better spatial
            # delta regressed hard (slice 3 of liam seg 5 is 73% CR)
            cost_cr = jnp.where(
                hp_c, eprev_c + lam_bits * 0.5, jnp.float32(3.0e38)
            )
            use_cr = cost_cr <= cost_rd
            new_ep = jnp.where(use_cr, pe_c, ep_rd)
            return new_ep, (new_ep, use_cr)

        def cols(x, tail_shape=()):
            return x.reshape((nby, nbx) + tail_shape).transpose(
                (1, 0) + tuple(range(2, 2 + len(tail_shape)))
            )

        xs = (
            cols(err_e, (e_n,)),
            cols(e_prev),
            cols(prev_ep),
            cols(ep),
            has_prev.reshape(nby, nbx).transpose(1, 0),
        )
        init = cols(ep)[0]  # column 0 prices against itself (first
        # block of each row keeps its natural delta; negligible)
        _, (ep_cols, selprev_cols) = jax.lax.scan(col_step, init, xs)
        ep = ep_cols.transpose(1, 0).reshape(-1)
        sel_is_prev = selprev_cols.transpose(1, 0).reshape(-1)
        sel = jnp.where(sel_is_prev, prev_sel, sel)

        # patterned blocks: plain CR snap (unchanged semantics)
        codes_new = rows(sel, sel_cb)
        e_new = err_with_codes(rows(ep, ep_lut), codes_new)
        cr = (~is_flat) & has_prev & (e_prev <= lam_cr * e_new + slack)
        ep = jnp.where(cr, prev_ep, ep)
        sel = jnp.where(cr, prev_sel, sel)
        return ep, sel

    def run(blocks_u8, color5, inten, sel_cb, assigns, sel_assigns,
            is_break, lam_bits, lam_cr):
        base = (
            (color5.astype(jnp.int32) << 3) | (color5.astype(jnp.int32) >> 2)
        ).astype(jnp.float32)
        ep_lut = jnp.concatenate([base, inten_tab[inten]], axis=1)

        def step(carry, xs):
            prev_ep, prev_sel, has_prev = carry
            blocks_i, assign_i, sel_i, brk = xs
            ep, sel = frame_body(
                blocks_i.astype(jnp.float32), ep_lut, sel_cb,
                assign_i, sel_i, prev_ep, prev_sel,
                jnp.broadcast_to(has_prev & ~brk, (nb,)),
                lam_bits, lam_cr,
            )
            return (ep, sel, jnp.bool_(True)), (ep, sel)

        init = (
            jnp.zeros(nb, jnp.int32),
            jnp.zeros(nb, jnp.int32),
            jnp.bool_(False),
        )
        _, (eps, sels) = jax.lax.scan(
            step, init, (blocks_u8, assigns, sel_assigns, is_break)
        )
        return eps, sels

    return jax.jit(run)


def _ensure_uniform_selector(pal: "Palettes") -> Tuple[int, int]:
    """Index and code of a uniform selector row, creating one if absent.

    basisu's codebooks always carry uniform rows (entry 0 of every liam
    segment is all-zero); ours come from k-means over ideal patterns and
    may lack one on detailed content — in that case the least-used row
    is overwritten (wire-legal: the codebook is ours to define)."""
    sels = pal.selectors
    uni = np.nonzero((sels == sels[:, :1]).all(axis=1))[0]
    if len(uni):
        counts = np.bincount(
            pal.block_selector.reshape(-1), minlength=len(sels)
        )
        best = uni[np.argmax(counts[uni])]
        return int(best), int(sels[best][0])
    counts = np.bincount(
        pal.block_selector.reshape(-1), minlength=len(sels)
    )
    victim = int(np.argmin(counts))
    pal.selectors = sels.copy()
    pal.selectors[victim] = 2  # +small modifier; base absorbs the rest
    return victim, 2


def delta_bias_assignments(
    pal: "Palettes",
    nby: int,
    nbx: int,
    *,
    dev_blocks,
    lam_bits: float = 60.0,
    lam_cr: float = 1.5,
    chain_breaks: Sequence[int] = (),
    **_legacy,
) -> None:
    """In-place endpoint-major refine over a whole segment (device).

    See _endpoint_major_fn. `dev_blocks`: the segment's device-resident
    [F*nb, 16, 3] uint8 blocks (shared with the palette build's
    upload)."""
    import jax.numpy as jnp

    f = pal.block_endpoint.shape[0]
    nb = nby * nbx
    s0_index, s0_code = _ensure_uniform_selector(pal)
    key = (nby, nbx, f, len(pal.color5), len(pal.selectors),
           s0_index, s0_code)
    fn = _DELTA_BIAS_JIT_CACHE.get(key)
    if fn is None:
        fn = _endpoint_major_fn(
            nby, nbx, len(pal.color5), len(pal.selectors),
            s0_index, s0_code,
        )
        _DELTA_BIAS_JIT_CACHE[key] = fn
    is_break = np.zeros(f, bool)
    for i in chain_breaks:
        if 0 <= i < f:
            is_break[i] = True
    eps, sels = fn(
        dev_blocks.reshape(f, nb, 16, 3),
        jnp.asarray(pal.color5),
        jnp.asarray(pal.inten, jnp.int32),
        jnp.asarray(pal.selectors, jnp.int32),
        jnp.asarray(pal.block_endpoint.reshape(f, nb), jnp.int32),
        jnp.asarray(pal.block_selector.reshape(f, nb), jnp.int32),
        jnp.asarray(is_break),
        float(lam_bits), float(lam_cr),
    )
    pal.block_endpoint = np.asarray(eps, np.int32).reshape(f, nb)
    pal.block_selector = np.asarray(sels, np.int32).reshape(f, nb)


_RATE_SWEEP_JIT_CACHE: Dict[Tuple, object] = {}


def rate_sweep_assignments(
    pal: "Palettes",
    nby: int,
    nbx: int,
    *,
    dev_blocks,
    lam_bits: float = 60.0,
    lam_cr: float = 1.5,
    chain_breaks: Sequence[int] = (),
) -> None:
    """In-place rate-distortion endpoint re-pick (see _rate_sweep_fn).

    Call with the palette in chain labeling (reorder_endpoint_palette)
    — the bits table prices index deltas in that space."""
    import jax.numpy as jnp

    f = pal.block_endpoint.shape[0]
    nb = nby * nbx
    s0_index, s0_code = _ensure_uniform_selector(pal)
    key = (nby, nbx, f, len(pal.color5), len(pal.selectors),
           s0_index, s0_code)
    fn = _RATE_SWEEP_JIT_CACHE.get(key)
    if fn is None:
        fn = _rate_sweep_fn(
            nby, nbx, len(pal.color5), len(pal.selectors),
            s0_index, s0_code,
        )
        _RATE_SWEEP_JIT_CACHE[key] = fn
    is_break = np.zeros(f, bool)
    for i in chain_breaks:
        if 0 <= i < f:
            is_break[i] = True
    eps, sels = fn(
        dev_blocks.reshape(f, nb, 16, 3),
        jnp.asarray(pal.color5),
        jnp.asarray(pal.inten, jnp.int32),
        jnp.asarray(pal.selectors, jnp.int32),
        jnp.asarray(pal.block_endpoint.reshape(f, nb), jnp.int32),
        jnp.asarray(pal.block_selector.reshape(f, nb), jnp.int32),
        jnp.asarray(is_break),
        float(lam_bits), float(lam_cr),
    )
    pal.block_endpoint = np.asarray(eps, np.int32).reshape(f, nb)
    pal.block_selector = np.asarray(sels, np.int32).reshape(f, nb)


_QUAD_JIT_CACHE: Dict[Tuple, object] = {}


def _quad_share_fn(nby: int, nbx: int):
    """Jitted per-frame 2x2 endpoint-quad unifier (see
    quad_share_endpoints)."""
    import jax
    import jax.numpy as jnp

    from uvol_tpu.codecs.basis.transcoder import INTEN_TABLES

    inten_tab = jnp.asarray(INTEN_TABLES, jnp.float32)  # [8, 4]

    def run(blocks, color5, inten, sel_onehot, eps, sels, tau):
        # blocks [NB,16,3] f32 · color5 [E,3] u8 · inten [E] i32 ·
        # sel_onehot [S,64] f32 (one-hot of each selector codeword per
        # pixel) · eps/sels [NB] i32
        nb = nby * nbx
        base = (
            (color5.astype(jnp.int32) << 3) | (color5.astype(jnp.int32) >> 2)
        ).astype(jnp.float32)  # [E, 3]
        ep_lut = jnp.concatenate([base, inten_tab[inten]], axis=1)  # [E,7]

        # the 4 candidate endpoints per 2x2 quad, broadcast to each block
        g = eps.reshape(nby, nbx)
        q = g.reshape(nby // 2, 2, nbx // 2, 2).transpose(0, 2, 1, 3)
        cand = q.reshape(nby // 2, nbx // 2, 4)  # [QY, QX, 4]
        cand_b = jnp.repeat(
            jnp.repeat(cand, 2, axis=0), 2, axis=1
        ).reshape(nb, 4)  # per block, the quad's 4 candidates

        def best_sel_err(ep_idx):
            """For each block coded with endpoint ep_idx[b]: the best
            codebook selector and its exact squared error — including
            the decoder's 0..255 clamp, which dominates on saturated
            content (unclamped argmin measured ~15 dB off on liam)."""
            look = _onehot_rows(ep_idx, ep_lut)  # [NB, 7]
            b3 = look[:, :3]
            m = look[:, 3:]  # [NB, 4] intensity modifiers
            clipped = jnp.clip(
                b3[:, None, :] + m[:, :, None], 0.0, 255.0
            )  # [NB, 4, 3] — the 4 decodable colors of this endpoint
            # cost[b,px,j] = |p - clipped_j|^2, expanded into exact-f32
            # matmul terms (every product < 2^24: pixels and clipped
            # values are <= 255, channel sums <= 3*255^2)
            p2 = jnp.sum(blocks * blocks, axis=2)  # [NB, 16]
            dot = jnp.einsum(
                "npc,njc->npj", blocks, clipped,
                precision=jax.lax.Precision.HIGHEST,
            )  # [NB, 16, 4]
            cc = jnp.sum(clipped * clipped, axis=2)  # [NB, 4]
            cost = (
                p2[:, :, None] - 2.0 * dot + cc[:, None, :]
            ).reshape(nb, 64)
            tot = jnp.dot(
                cost, sel_onehot.T,
                precision=jax.lax.Precision.HIGHEST,
                preferred_element_type=jnp.float32,
            )  # [NB, S]
            sel = jnp.argmin(tot, axis=1).astype(jnp.int32)
            return sel, jnp.min(tot, axis=1)

        errs = []
        sels_c = []
        for c in range(4):
            s, e = best_sel_err(cand_b[:, c])
            errs.append(e)
            sels_c.append(s)
        errs = jnp.stack(errs, axis=1)  # [NB, 4]
        # quad total error per candidate
        eg = errs.reshape(nby // 2, 2, nbx // 2, 2, 4)
        quad_err = eg.sum(axis=(1, 3))  # [QY, QX, 4]
        win = jnp.argmin(quad_err, axis=2)  # [QY, QX]
        # distortion of keeping each block's own assignment: its own
        # endpoint sits at its quadrant position in the candidate list
        yy = jnp.arange(nby)[:, None]
        xx = jnp.arange(nbx)[None, :]
        own_pos = ((yy % 2) * 2 + (xx % 2)).reshape(nb)
        e_own = jnp.take_along_axis(errs, own_pos[:, None], axis=1)[:, 0]
        quad_base = e_own.reshape(nby // 2, 2, nbx // 2, 2).sum(axis=(1, 3))
        # rate-distortion gate: unify only where the added distortion is
        # within tau (boundary quads with incompatible members keep
        # their per-block choices)
        share = (
            jnp.min(quad_err, axis=2) <= quad_base + tau
        )  # [QY, QX]
        share_b = jnp.repeat(
            jnp.repeat(share, 2, axis=0), 2, axis=1
        ).reshape(nb)
        win_b = jnp.repeat(
            jnp.repeat(win, 2, axis=0), 2, axis=1
        ).reshape(nb)
        new_ep = jnp.take_along_axis(
            cand_b, win_b[:, None], axis=1
        )[:, 0]
        sels_c = jnp.stack(sels_c, axis=1)  # [NB, 4]
        new_sel = jnp.take_along_axis(
            sels_c, win_b[:, None], axis=1
        )[:, 0]
        new_ep = jnp.where(share_b, new_ep, eps)
        new_sel = jnp.where(share_b, new_sel, sels)
        return new_ep, new_sel

    return jax.jit(run, static_argnames=())


def quad_share_endpoints(
    blocks: np.ndarray, pal: "Palettes", nby: int, nbx: int,
    tau: float = 2048.0,
) -> None:
    """Unify each 2x2 block quad onto one endpoint index, in place.

    The slice format prices endpoints per block (a delta symbol each) but
    predicts them per 2x2 quad, so an assignment field that is constant
    over quads pays ONE delta per quad plus a single repeated pred
    symbol — the granularity basisu's frontend optimizes at. Candidates
    are the quad's own four assigned endpoints; the winner minimizes the
    exact quad error with per-block best selectors re-picked for it
    (selectors stay per-block, so detail sharper than 8x8 survives).
    Quality cost is bounded: the winning candidate's error is within the
    four blocks' own fits. Static regions keep bitwise-stable quads, so
    emission-time CR still fires frame-to-frame."""
    import jax.numpy as jnp

    f = pal.block_endpoint.shape[0]
    if nby % 2 or nbx % 2:
        raise ValueError(
            f"endpoint quads need an even block grid, got {nby}x{nbx} "
            "(pad the input to a multiple of 8 pixels or encode without "
            "endpoint_quads)"
        )
    nb = nby * nbx
    key = (nby, nbx)
    fn = _QUAD_JIT_CACHE.get(key)
    if fn is None:
        fn = _quad_share_fn(nby, nbx)
        _QUAD_JIT_CACHE[key] = fn
    S = len(pal.selectors)
    sel_onehot = np.zeros((S, 16, 4), np.float32)
    sidx = np.arange(S)[:, None]
    sel_onehot[sidx, np.arange(16)[None, :], pal.selectors] = 1.0
    sel_onehot = jnp.asarray(sel_onehot.reshape(S, 64))
    color5 = jnp.asarray(pal.color5)
    inten = jnp.asarray(pal.inten, jnp.int32)
    blocks = np.asarray(blocks).reshape(f, nb, 16, 3)
    for i in range(f):
        ep, sel = fn(
            jnp.asarray(blocks[i], jnp.float32), color5, inten, sel_onehot,
            jnp.asarray(pal.block_endpoint[i], jnp.int32),
            jnp.asarray(pal.block_selector[i], jnp.int32),
            jnp.float32(tau),
        )
        pal.block_endpoint[i] = np.asarray(ep, np.int32)
        pal.block_selector[i] = np.asarray(sel, np.int32)


def rdo_refine_assignments(
    blocks: np.ndarray,
    pal: "Palettes",
    nby: int,
    nbx: int,
    *,
    lam: float = 1.25,
    lam_sel: float = 1.25,
    lam_cr: float = 1.5,
    chain_breaks: Sequence[int] = (),
    dev_blocks=None,
    dev_assign=None,
    dev_sel_assign=None,
) -> None:
    """In-place spatial/temporal RDO over per-frame assignments.

    `chain_breaks`: frame indices whose slice is emitted as an I-slice
    (no CR symbols) — the temporal term must not reward matching the
    previous frame there (e.g. the first alpha slice when rgb and alpha
    frames share one linear array).

    The whole segment runs as one jitted lax.scan over the frame axis.
    `dev_blocks`/`dev_assign`/`dev_sel_assign` let build_palettes hand
    over arrays already resident on device (one blocks upload shared
    with the k-means core); the host `blocks`/`pal` fields are the
    fallback source."""
    import jax.numpy as jnp

    f = pal.block_endpoint.shape[0]
    nb = nby * nbx
    key = (nby, nbx, f)
    fn = _RDO_JIT_CACHE.get(key)
    if fn is None:
        fn = _rdo_refine_fn(nby, nbx)
        _RDO_JIT_CACHE[key] = fn
    if dev_blocks is None:
        import jax

        # uint8 (4x smaller) + async device_put (see build_palettes)
        dev_blocks = jax.device_put(np.ascontiguousarray(blocks))
    dev_blocks = dev_blocks.reshape(f, nb, 16, 3)
    if dev_assign is None:
        dev_assign = jnp.asarray(pal.block_endpoint, jnp.int32)
    if dev_sel_assign is None:
        dev_sel_assign = jnp.asarray(pal.block_selector, jnp.int32)
    is_break = np.zeros(f, bool)
    for i in chain_breaks:
        if 0 <= i < f:
            is_break[i] = True
    eps, sels = fn(
        dev_blocks,
        jnp.asarray(pal.color5),
        jnp.asarray(pal.inten, jnp.int32),
        jnp.asarray(pal.selectors, jnp.int32),
        dev_assign.reshape(f, nb),
        dev_sel_assign.reshape(f, nb),
        jnp.asarray(is_break),
        float(lam), float(lam_sel), float(lam_cr),
    )
    pal.block_endpoint = np.asarray(eps, np.int32).reshape(f, nb)
    pal.block_selector = np.asarray(sels, np.int32).reshape(f, nb)


def encode_endpoints_stream(color5: np.ndarray, inten: np.ndarray) -> bytes:
    deltas: List[Tuple[int, int]] = []  # (model, delta) per color component
    inten_deltas: List[int] = []
    prev_color5 = [16, 16, 16]
    prev_inten = 0
    for e in range(len(color5)):
        inten_deltas.append((int(inten[e]) - prev_inten) & 7)
        prev_inten = int(inten[e])
        for c in range(3):
            prev = prev_color5[c]
            if prev <= COLOR5_PAL0_PREV_HI:
                model = 0
            elif prev <= COLOR5_PAL1_PREV_HI:
                model = 1
            else:
                model = 2
            deltas.append((model, (int(color5[e, c]) - prev) & 31))
            prev_color5[c] = int(color5[e, c])
    freqs = [[0] * 32 for _ in range(3)]
    for model, d in deltas:
        freqs[model][d] += 1
    for fr in freqs:
        if sum(fr) == 0:
            fr[0] = 1
    ifreq = [0] * 8
    for d in inten_deltas:
        ifreq[d] += 1
    encs = [HuffmanEncoder(fr) for fr in freqs]
    ienc = HuffmanEncoder(ifreq)
    bw = BitWriter()
    for enc in encs:
        enc.write_table(bw)
    ienc.write_table(bw)
    bw.put_bits(0, 1)  # grayscale = 0
    di = iter(deltas)
    for e in range(len(color5)):
        ienc.encode(bw, inten_deltas[e])
        for _ in range(3):
            model, d = next(di)
            encs[model].encode(bw, d)
    return bw.getvalue()


def encode_selectors_stream(selectors: np.ndarray) -> bytes:
    """selectors [S, 16] 2-bit → delta-coded stream (used_raw=0 path)."""
    rows = selectors.reshape(-1, 4, 4)
    bytes_per_row = (
        rows[..., 0] | (rows[..., 1] << 2) | (rows[..., 2] << 4) | (rows[..., 3] << 6)
    ).astype(np.uint8)  # [S, 4]
    deltas: List[int] = []
    prev = [0, 0, 0, 0]
    for srow in bytes_per_row:
        for y in range(4):
            d = int(srow[y]) ^ prev[y]
            prev[y] = int(srow[y])
            deltas.append(d)
    freq = [0] * 256
    for d in deltas:
        freq[d] += 1
    enc = HuffmanEncoder(freq)
    bw = BitWriter()
    bw.put_bits(0, 1)  # used_global_cb
    bw.put_bits(0, 1)  # used_hybrid_cb
    bw.put_bits(0, 1)  # used_raw
    enc.write_table(bw)
    for d in deltas:
        enc.encode(bw, d)
    return bw.getvalue()


# ---------------------------------------------------------------------------
# Slice emission (inverse of decode_etc1s_slice)
# ---------------------------------------------------------------------------


def encode_etc1s_slice_bits(
    eps: np.ndarray,
    sels: np.ndarray,
    prev: Optional[Tuple[np.ndarray, np.ndarray]],
    num_endpoints: int,
    num_selectors: int,
    history_size: int,
    encoders: Optional[Dict[str, HuffmanEncoder]] = None,
    freq_out: Optional[Dict[str, List[int]]] = None,
) -> Optional[bytes]:
    """One pass over the slice in decoder order. With `freq_out`, collects
    symbol frequencies (pass 1); with `encoders`, emits bits (pass 2).
    The state machines are identical to decode_etc1s_slice's, so emission
    order equals consumption order by construction.
    """
    nby, nbx = eps.shape
    is_p = prev is not None

    # native fast path (etc1s_native.cpp, identical state machines)
    if (encoders is None) != (freq_out is None):
        from uvol_tpu import native as uvt_native

        if encoders is None:
            res = uvt_native.etc1s_slice_native(
                eps, sels, prev, num_endpoints, num_selectors, history_size
            )
            if res is not None:
                for k in ("pred", "delta", "sel", "rle"):
                    fr = freq_out[k]
                    arr = res[k]
                    if len(fr) < len(arr):
                        fr.extend([0] * (len(arr) - len(fr)))
                    for s in np.nonzero(arr)[0]:
                        fr[int(s)] += int(arr[s])
                return None
        else:
            tables = {}
            for k, enc in encoders.items():
                n = len(enc.code_sizes)
                codes = np.zeros(n, np.uint32)
                lens = np.zeros(n, np.uint8)
                for sym, (code, length) in enc.codes.items():
                    codes[sym] = code
                    lens[sym] = length
                tables[k] = (codes, lens)
            bits = uvt_native.etc1s_slice_native(
                eps, sels, prev, num_endpoints, num_selectors, history_size,
                code_tables=tables,
            )
            if bits is not None:
                return bits

    bw = BitWriter() if encoders is not None else None

    # pre-choose predictions (must be stable across both passes)
    pred = np.full((nby, nbx), PRED_EXPLICIT, np.int32)
    for by in range(nby):
        for bx in range(nbx):
            ep = int(eps[by, bx])
            if (
                is_p
                and ep == int(prev[0][by, bx])
                and int(sels[by, bx]) == int(prev[1][by, bx])
            ):
                pred[by, bx] = PRED_CR
                continue
            if bx > 0 and ep == int(eps[by, bx - 1]):
                pred[by, bx] = PRED_LEFT
            elif by > 0 and ep == int(eps[by - 1, bx]):
                pred[by, bx] = PRED_ABOVE
            else:
                pred[by, bx] = PRED_EXPLICIT

    def note(stream: str, sym: int) -> None:
        if freq_out is not None:
            fr = freq_out[stream]
            while len(fr) <= sym:
                fr.append(0)
            fr[sym] += 1

    def emit(stream: str, sym: int) -> None:
        if bw is not None:
            encoders[stream].encode(bw, sym)
        note(stream, sym)

    # quad symbol stream state
    quad_syms: List[int] = []
    for by in range(0, nby, 2):
        for bx in range(0, nbx, 2):
            p00 = int(pred[by, bx])
            p01 = int(pred[by, bx + 1]) if bx + 1 < nbx else 0
            p10 = int(pred[by + 1, bx]) if by + 1 < nby else 0
            p11 = (
                int(pred[by + 1, bx + 1]) if by + 1 < nby and bx + 1 < nbx else 0
            )
            quad_syms.append(p00 | (p01 << 2) | (p10 << 4) | (p11 << 6))
    # plan pred emissions (literal / repeat escapes) per quad index
    quad_plan: List[Optional[Tuple[int, int]]] = [None] * len(quad_syms)
    i = 0
    while i < len(quad_syms):
        sym = quad_syms[i]
        run = 1
        while i + run < len(quad_syms) and quad_syms[i + run] == sym:
            run += 1
        quad_plan[i] = (sym, -1)
        rest = run - 1
        # the escape quad consumes prev_sym itself AND sets pred_rle=vlc+2
        # further quads, so it covers vlc+3 of the remaining `rest` quads —
        # only usable when rest >= 3 (decode_etc1s_slice:316-325)
        if rest >= 3:
            quad_plan[i + 1] = (ENDPOINT_PRED_REPEAT_LAST, rest - 3)
            # quads i+2..i+run-1 consume the rle counter: no emission
        else:
            for k in range(1, run):
                quad_plan[i + k] = (sym, -1)
        i += run

    # selector runs of hist[0]: plan with lookahead using a simulated MTF
    hist = ApproxMoveToFront(history_size)
    prev_ep = 0
    sel_rle_left = 0
    qi = 0
    for by in range(nby):
        for bx in range(nbx):
            if (by & 1) == 0 and (bx & 1) == 0:
                plan = quad_plan[qi]
                qi += 1
                if plan is not None:
                    sym, extra = plan
                    emit("pred", sym)
                    if sym == ENDPOINT_PRED_REPEAT_LAST and bw is not None:
                        write_vlc(bw, extra, 4)

            p = int(pred[by, bx])
            sel = int(sels[by, bx])

            if p != PRED_CR:
                ep = int(eps[by, bx])
                if p == PRED_EXPLICIT:
                    emit("delta", (ep - prev_ep) % num_endpoints)
                prev_ep = ep

            # selector stream (CR blocks participate too; the decoder
            # DISCARDS a CR block's selector value, so CR blocks are
            # wildcards — they match any run and may emit anything)
            if sel_rle_left:
                sel_rle_left -= 1
                continue
            if sel == hist[0] or p == PRED_CR:
                # measure the run length of hist[0]/wildcards from here
                run = 0
                yy, xx = by, bx
                while yy < nby:
                    if (
                        int(sels[yy, xx]) == hist[0]
                        or int(pred[yy, xx]) == PRED_CR
                    ):
                        run += 1
                    else:
                        break
                    xx += 1
                    if xx == nbx:
                        xx = 0
                        yy += 1
                if run >= 2:
                    rle = run - 1  # decode: sel_rle = rle_sym + 1 more blocks
                    # decode: sym -> if 63: += vlc(7); sel_rle = rle + 1
                    base_rle = rle - 1
                    if base_rle >= 63:
                        emit("sel", num_selectors + history_size)
                        emit("rle", 63)
                        if bw is not None:
                            write_vlc(bw, base_rle - 63, 7)
                    else:
                        emit("sel", num_selectors + history_size)
                        emit("rle", base_rle)
                    sel_rle_left = run - 1
                else:
                    emit("sel", num_selectors + 0)
                    hist.use(0)
                continue
            idx = None
            for k in range(history_size):
                if hist[k] == sel:
                    idx = k
                    break
            if idx is not None and idx > 0:
                emit("sel", num_selectors + idx)
                hist.use(idx)
            else:
                emit("sel", sel)
                hist.add(sel)

    return bw.getvalue() if bw is not None else None


# ---------------------------------------------------------------------------
# Top level
# ---------------------------------------------------------------------------


def sort_endpoint_palette(pal: Palettes) -> None:
    """Reorder the endpoint codebook along its color axis, in place.

    The slice format delta-codes explicit endpoint indices in raster
    order ((ep - prev_ep) mod E, Huffman over the delta alphabet), so
    byte cost tracks the index distance between blocks that are spatial
    neighbors in the image. k-means emits clusters in arbitrary order —
    measured ~7.5-bit delta entropy on the liam corpus, near the 8-bit
    maximum — while a codebook sorted along the dominant color axis maps
    smooth image gradients onto adjacent indices (basisu ships the same
    optimization: its backend remaps endpoint indices before coding, and
    its files show ~3-bit P-slice delta entropy). Sorting also shrinks
    the endpoint codebook section itself, whose color5 components are
    delta-coded in index order (encode_endpoints)."""
    ext = (pal.color5.astype(np.int64) << 3) | (pal.color5.astype(np.int64) >> 2)
    luma = ext @ np.array([299, 587, 114], np.int64)
    # stable sort, intensity as the minor key so equal-color entries
    # with different contrast stay adjacent
    key = luma * 8 + pal.inten.astype(np.int64)
    perm = np.argsort(key, kind="stable")
    inv = np.empty(len(perm), np.int32)
    inv[perm] = np.arange(len(perm), dtype=np.int32)
    pal.color5 = pal.color5[perm]
    pal.inten = pal.inten[perm]
    pal.block_endpoint = inv[pal.block_endpoint]


def _palette_psnr(frames_rgb: np.ndarray, pal: Palettes,
                  nby: int, nbx: int) -> float:
    """PSNR of the palette reconstruction against the source frames
    (host math over the assignment grids; the encoder's quality-floor
    self-measure)."""
    from uvol_tpu.codecs.basis.transcoder import INTEN_TABLES

    f = pal.block_endpoint.shape[0]
    nb = nby * nbx
    blocks = (
        frames_rgb.reshape(f, nby, 4, nbx, 4, 3)
        .transpose(0, 1, 3, 2, 4, 5)
        .reshape(f, nb, 16, 3)
    )
    base = (pal.color5.astype(np.int64) << 3) | (
        pal.color5.astype(np.int64) >> 2
    )
    mods = np.asarray(INTEN_TABLES)[pal.inten]
    codes = pal.selectors[pal.block_selector]
    bmod = np.take_along_axis(mods[pal.block_endpoint], codes, axis=2)
    recon = np.clip(
        base[pal.block_endpoint][:, :, None, :] + bmod[..., None], 0, 255
    )
    mse = ((recon.astype(np.float64) - blocks) ** 2).mean()
    return float(10 * np.log10(255**2 / max(mse, 1e-12)))


def choose_codebook_sizes(frames: np.ndarray) -> Tuple[int, int]:
    """Content-adaptive (num_endpoints, num_selectors) for a segment.

    basisu grows its codebooks on hard content (the liam corpus shows
    1501 endpoints / 738 selectors on its busiest segments vs the fixed
    256/256 this encoder used through round 3 — PERF.md §8). Hardness
    probe: mean within-4x4-block luma standard deviation (block
    "activity") plus the mean luma gradient BETWEEN neighboring blocks
    (palette diversity) — cheap host statistics that track how many
    distinct (base color, contrast) pairs the content needs."""
    rgb = frames[..., :3].astype(np.float32)
    luma = rgb @ np.array([0.299, 0.587, 0.114], np.float32)
    f, h, w = luma.shape
    b = luma.reshape(f, h // 4, 4, w // 4, 4).transpose(0, 1, 3, 2, 4)
    b = b.reshape(f, h // 4, w // 4, 16)
    act = float(np.mean(b.std(axis=-1)))
    means = b.mean(axis=-1)
    grad = float(
        np.mean(np.abs(np.diff(means, axis=2)))
        + np.mean(np.abs(np.diff(means, axis=1)))
    ) / 2.0
    hardness = act + 0.5 * grad
    if hardness < 6.0:
        return 256, 256
    if hardness < 12.0:
        return 512, 384
    if hardness < 20.0:
        return 1024, 512
    return 1536, 768


def encode_ktx2_etc1s(
    frames: np.ndarray,
    *,
    num_endpoints=256,
    num_selectors=256,
    history_size: int = 64,
    kmeans_iters: int = 6,
    srgb: bool = True,
    rdo: bool = True,
    rdo_lambdas: Tuple[float, float, float] = (1.25, 1.5, 1.5),
    delta_window: int = 16,
    delta_lambda: float = 60.0,
    min_psnr_db: float = 35.0,
    endpoint_quads: bool = False,
    mesh: Optional["object"] = None,
) -> bytes:
    """[F, H, W, 3|4] uint8 → BasisLZ-supercompressed KTX2 (video layers).

    `num_endpoints` / `num_selectors` accept "auto": per-segment
    content-adaptive sizing (choose_codebook_sizes) — basisu's behavior
    on hard content. Palettes >= 512 additionally run the delta-aware
    assignment stage (delta_bias_assignments) so the bigger index space
    stays cheap to code.

    `mesh` shards the palette build's block axis over a `frames` device
    mesh (see build_palettes).

    RGBA input adds one alpha slice per image — even when the channel is
    fully opaque, matching basisu `-force_alpha`, so segment-by-segment
    callers always get the same output shape: alpha is coded as an ETC1S
    gray slice sharing the global endpoint/selector codebooks, with its
    own conditional-replenishment chain; the transcoder reads the decoded
    green channel back as alpha. Pass 3-channel input for RGB-only."""
    f, h, w, nch = frames.shape
    nbx, nby = w // 4, h // 4
    if num_endpoints == "auto" or num_selectors == "auto":
        auto_e, auto_s = choose_codebook_sizes(frames)
        if num_endpoints == "auto":
            num_endpoints = auto_e
        if num_selectors == "auto":
            num_selectors = auto_s
    has_alpha = nch == 4
    rgb = frames[..., :3]
    if has_alpha:
        alpha_rgb = np.repeat(frames[..., 3:4], 3, axis=-1)
        pal_input = np.concatenate([rgb, alpha_rgb], axis=0)
    else:
        pal_input = rgb
    n_slices = 2 * f if has_alpha else f
    # quality floor: the delta-aware refinement trades distortion for
    # rate under a global lambda — content where the flips come too
    # cheap can overshoot (liam segs 22/26 measured ~-5 dB at the
    # corpus-tuned lambda with bytes far below budget). Self-measure
    # and retry the build at gentler lambdas until the floor holds.
    lam_ladder = [delta_lambda]
    if delta_window > 0:
        lam_ladder += [delta_lambda / 3.0, delta_lambda / 10.0, 0.0]
    pal = None
    for lam_try in lam_ladder:
        pal = build_palettes(
            pal_input, num_endpoints, num_selectors, kmeans_iters,
            rdo=rdo, rdo_lambdas=rdo_lambdas,
            delta_window=delta_window if lam_try > 0 else 0,
            delta_lambda=lam_try,
            # the alpha chain starts a fresh I-slice at index f
            rdo_chain_breaks=(f,) if has_alpha else (),
            mesh=mesh,
        )
        if len(lam_ladder) == 1 or _palette_psnr(
            pal_input, pal, nby, nbx
        ) >= min_psnr_db:
            break
    if endpoint_quads:
        quad_blocks = np.ascontiguousarray(
            pal_input.reshape(n_slices, nby, 4, nbx, 4, 3)
            .transpose(0, 1, 3, 2, 4, 5)
            .reshape(n_slices, nby * nbx, 16, 3)
        )
        quad_share_endpoints(quad_blocks, pal, nby, nbx)
    num_endpoints = len(pal.color5)
    num_selectors = len(pal.selectors)

    # slice s of image i: rgb = index i, alpha = index f + i
    eps_f = pal.block_endpoint.reshape(n_slices, nby, nbx)
    sels_f = pal.block_selector.reshape(n_slices, nby, nbx)

    def slice_plan():
        """(slice_index, prev_slice_index | None) per slice, emit order."""
        for i in range(f):
            yield i, (i - 1 if i > 0 else None)
            if has_alpha:
                yield f + i, (f + i - 1 if i > 0 else None)

    # pass 1: frequencies over all slices
    freqs: Dict[str, List[int]] = {
        "pred": [0] * (ENDPOINT_PRED_REPEAT_LAST + 1),
        "delta": [0] * 1,
        "sel": [0] * (num_selectors + history_size + 1),
        "rle": [0] * 64,
    }
    for si, pi in slice_plan():
        prev = (eps_f[pi], sels_f[pi]) if pi is not None else None
        encode_etc1s_slice_bits(
            eps_f[si], sels_f[si], prev, num_endpoints, num_selectors,
            history_size, freq_out=freqs,
        )
    # pad alphabets to full size expected by the decoder's index space
    freqs["delta"] += [0] * (num_endpoints - len(freqs["delta"]))
    for k in freqs:
        if sum(freqs[k]) == 0:
            freqs[k][0] = 1
    encoders = {k: HuffmanEncoder(v) for k, v in freqs.items()}

    # tables_data (decode_slice_models order)
    tbw = BitWriter()
    encoders["pred"].write_table(tbw)
    encoders["delta"].write_table(tbw)
    encoders["sel"].write_table(tbw)
    encoders["rle"].write_table(tbw)
    tbw.put_bits(history_size, 13)
    tables_data = tbw.getvalue()

    # pass 2: emit slices
    level = bytearray()
    descs: List[KTX2ImageDesc] = []
    for i in range(f):
        prev = (eps_f[i - 1], sels_f[i - 1]) if i > 0 else None
        bits = encode_etc1s_slice_bits(
            eps_f[i], sels_f[i], prev, num_endpoints, num_selectors,
            history_size, encoders=encoders,
        )
        a_off = a_len = 0
        rgb_off = len(level)
        level.extend(bits)
        if has_alpha:
            pa = (eps_f[f + i - 1], sels_f[f + i - 1]) if i > 0 else None
            abits = encode_etc1s_slice_bits(
                eps_f[f + i], sels_f[f + i], pa, num_endpoints,
                num_selectors, history_size, encoders=encoders,
            )
            a_off = len(level)
            a_len = len(abits)
            level.extend(abits)
        descs.append(
            KTX2ImageDesc(
                image_flags=KTX2ImageDesc.IS_P_FRAME if i > 0 else 0,
                rgb_slice_byte_offset=rgb_off,
                rgb_slice_byte_length=len(bits),
                alpha_slice_byte_offset=a_off,
                alpha_slice_byte_length=a_len,
            )
        )

    g = BasisLZGlobalData(
        endpoint_count=num_endpoints,
        selector_count=num_selectors,
        endpoints_data=encode_endpoints_stream(pal.color5, pal.inten),
        selectors_data=encode_selectors_stream(pal.selectors),
        tables_data=tables_data,
        extended_data=b"",
        image_descs=descs,
    )
    header = KTX2Header(
        vk_format=0,
        type_size=1,
        pixel_width=w,
        pixel_height=h,
        pixel_depth=0,
        layer_count=f if f > 1 else 0,
        face_count=1,
        level_count=1,
        supercompression_scheme=1,  # BasisLZ
    )
    return write_ktx2(
        header,
        [KTX2Level(bytes(level), len(level))],
        dfd=make_basis_dfd(srgb=srgb, has_alpha=has_alpha),
        basis_lz=g,
    )


def encode_ktx2_etc1s_rate_target(
    frames: np.ndarray,
    target_bytes: int,
    *,
    payload_of=None,
    **kw,
) -> bytes:
    """Rate-controlled ETC1S encode: walk a compression ladder (RDO
    lambda escalation, then codebook shrink) until the output fits
    `target_bytes`, returning the highest-quality fitting blob (or the
    smallest achieved if none fits). This is the per-segment rate
    adaptation basisu's RDO does implicitly — used to hold every segment
    at <= the reference encoder's bytes (docs/etc1s_sweep.jsonl).

    `payload_of(blob)` measures comparable bytes (defaults to len)."""
    ladder = [
        {},
        # delta-aware escalation first (the adaptive-palette era's rate
        # knob: stronger flips/sweeps trade the PSNR headroom the big
        # palettes create; min_psnr_db floors the damage)
        {"delta_lambda": 300.0, "min_psnr_db": 33.0},
        {"delta_lambda": 600.0, "min_psnr_db": 31.0,
         "rdo_lambdas": (2.5, 3.0, 3.0)},
        {"rdo_lambdas": (2.5, 3.0, 3.0)},
        {"rdo_lambdas": (4.0, 5.0, 5.0), "num_selectors": 192},
        {"rdo_lambdas": (6.0, 7.0, 7.0),
         "num_endpoints": 192, "num_selectors": 160},
        {"rdo_lambdas": (9.0, 11.0, 11.0),
         "num_endpoints": 160, "num_selectors": 128},
        {"rdo_lambdas": (14.0, 16.0, 16.0),
         "num_endpoints": 128, "num_selectors": 96},
    ]
    measure = payload_of or len
    best = None
    for step in ladder:
        blob = encode_ktx2_etc1s(frames, **{**kw, **step})
        size = measure(blob)
        if best is None or size < best[0]:
            best = (size, blob)
        if size <= target_bytes:
            return blob
    return best[1]
