"""Exact ETC1S endpoint assignment: the Triton kernel (interpret mode on
the CPU), the XLA formulation and the choice between them, against an
int64 numpy reference of the full clip-aware block error."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from uvol_tpu.codecs.basis import etc1s_assign as A
from uvol_tpu.codecs.basis.transcoder import INTEN_TABLES


def _reference_assign(blocks, base, inten):
    """argmin_e sum_px min_j |p - clip(base_e + m_j)|^2 in int64; numpy's
    argmin keeps the lowest index on ties."""
    p = blocks.astype(np.int64)  # [N, 16, 3]
    mods = np.asarray(INTEN_TABLES, np.int64)[inten]  # [E, 4]
    recon = np.clip(base[:, None, :] + mods[:, :, None], 0, 255)  # [E, 4, 3]
    d = p[:, None, :, None, :] - recon[None, :, None, :, :]  # [N,E,16,4,3]
    err = np.sum(np.min(np.sum(d * d, -1), -1), -1)  # [N, E]
    return np.argmin(err, axis=1)


def _case(n, e, seed, dups=()):
    r = np.random.default_rng(seed)
    blocks = r.integers(0, 256, (n, 16, 3)).astype(np.uint8)
    # a few flat and saturated blocks: exact ties and clipped modifiers
    blocks[0] = 0
    blocks[1] = 255
    blocks[2] = 128
    base = r.integers(0, 256, (e, 3)).astype(np.int64)
    inten = r.integers(0, 8, e)
    for lo, hi in dups:  # identical endpoints: ties must go to `lo`
        base[hi], inten[hi] = base[lo], inten[lo]
        blocks[3] = np.clip(base[lo], 0, 255).astype(np.uint8)
    return blocks, base, inten


def _consts(base, inten):
    basef = jnp.asarray(base, jnp.float32)
    mods = jnp.asarray(np.asarray(INTEN_TABLES, np.float32)[inten])
    return basef, *A.effective_modifiers(basef, mods)


#: E below, at and between the endpoint tiles; N never a multiple of the
#: block tile; duplicate endpoints within a tile and across tiles
CASES = [(301, 7, ((1, 5),)), (257, 256, ((10, 200),)), (131, 1000, ((5, 900),))]


@pytest.mark.parametrize("n,e,dups", CASES)
def test_triton_kernel_interpret_matches_int64_reference(n, e, dups):
    blocks, base, inten = _case(n, e, seed=e, dups=dups)
    basef, me, q = _consts(base, inten)
    got = np.asarray(
        A.assign_endpoints_triton(
            A.pixel_planes(jnp.asarray(blocks)),
            A.endpoint_const_rows(basef, me, q),
            n=n, interpret=True,
        )
    )
    ref = _reference_assign(blocks, base, inten)
    np.testing.assert_array_equal(got, ref)
    assert not np.isin(got, [hi for _, hi in dups]).any()


@pytest.mark.parametrize("n,e,dups", CASES)
def test_xla_formulation_matches_int64_reference(n, e, dups):
    blocks, base, inten = _case(n, e, seed=e + 1, dups=dups)
    basef, me, q = _consts(base, inten)
    got = np.asarray(
        A.assign_endpoints_xla(jnp.asarray(blocks, jnp.float32), basef, me, q)
    )
    np.testing.assert_array_equal(got, _reference_assign(blocks, base, inten))


def test_kernel_inputs_are_padded_to_the_tiles():
    blocks, base, inten = _case(13, 130, seed=3)
    basef, me, q = _consts(base, inten)
    planes = A.pixel_planes(jnp.asarray(blocks))
    const = A.endpoint_const_rows(basef, me, q)
    n_pad = -(-13 // A.TILE_B) * A.TILE_B
    e_pad = -(-130 // A.TILE_E) * A.TILE_E
    assert n_pad > 13 and e_pad > 130  # both tiles need padding here
    assert planes.shape == (48, n_pad) and planes.dtype == jnp.float32
    assert const.shape == (20, e_pad)
    # row c*16 + p holds channel c of pixel p; padded blocks are zero
    np.testing.assert_array_equal(np.asarray(planes[5 * 1 + 16, 2]), blocks[2, 5, 1])
    assert not np.asarray(planes[:, 13:]).any()
    # padded endpoints carry the sentinel code constant and nothing else
    pad = np.asarray(const[:, 130:])
    assert (pad[[3, 7, 11, 15]] == A._PAD_Q).all()
    assert not np.delete(pad, [3, 7, 11, 15], axis=0).any()
    with pytest.raises(ValueError, match="not padded"):
        A.assign_endpoints_triton(planes[:, :13], const, n=13, interpret=True)


@pytest.mark.parametrize("platform,kernel", [("gpu", True), ("cpu", False)])
def test_backend_choice(platform, kernel):
    assert A.use_gpu_kernel(platform) is kernel


def test_build_palettes_picks_xla_on_cpu():
    from uvol_tpu.codecs.basis import etc1s_encode

    r = np.random.default_rng(4)
    frames = r.integers(0, 256, (1, 16, 16, 3)).astype(np.uint8)
    etc1s_encode._PALETTE_JIT_CACHE.clear()
    etc1s_encode.build_palettes(frames, 8, 8, 2, rdo=False)
    assert [k[-1] for k in etc1s_encode._PALETTE_JIT_CACHE] == [False]


def test_palette_core_kernel_path_matches_xla_path():
    """The whole palette build with the kernel (interpret mode) returns
    exactly what the XLA path returns: the assignments are exact."""
    from uvol_tpu.codecs.basis.etc1s_encode import _palette_core_fn

    r = np.random.default_rng(5)
    img = np.clip(
        np.linspace(0, 255, 32)[None, :, None]
        + r.integers(-40, 40, (32, 32, 3)), 0, 255
    ).astype(np.uint8)
    blocks = jnp.asarray(
        img.reshape(8, 4, 8, 4, 3).transpose(0, 2, 1, 3, 4).reshape(-1, 16, 3)
    )
    xla = jax.jit(_palette_core_fn(16, 16, 2))(blocks)
    kern = jax.jit(_palette_core_fn(16, 16, 2, gpu_kernel=True, interpret=True))(
        blocks
    )
    for a, b in zip(xla, kern):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.gpu
def test_triton_kernel_compiled_matches_xla():
    """The compiled kernel on the card (chip_smoke.py's etc1s phase runs
    the same check at the full liam segment shape)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: the compiled Triton kernel has no CPU lowering")
    blocks, base, inten = _case(4099, 1000, seed=7, dups=((5, 900),))
    basef, me, q = _consts(base, inten)
    dev = jnp.asarray(blocks)
    got = A.assign_endpoints_triton(
        A.pixel_planes(dev), A.endpoint_const_rows(basef, me, q), n=4099
    )
    ref = A.assign_endpoints_xla(dev.astype(jnp.float32), basef, me, q)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
