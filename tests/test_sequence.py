import numpy as np
import pytest

from uvol_tpu.codecs.basis.etc import (
    blocks_to_image,
    decode_etc1_blocks,
    encode_etc1_blocks,
    image_to_blocks,
    pack_etc1_payload,
    pack_words2,
    unpack_etc1_payload,
    unpack_words2,
)
from uvol_tpu.containers.ktx2 import read_ktx2
from uvol_tpu.models.sequence import (
    GeometryFrameSet,
    GeometrySequenceCodec,
    TextureSequenceCodec,
)


def _frames(F=4, N=2000, seed=0):
    r = np.random.default_rng(seed)
    theta, phi = r.uniform(0, np.pi, N), r.uniform(0, 2 * np.pi, N)
    base = np.stack(
        [np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi), np.cos(theta)], -1
    )
    pos = np.stack([base * (1 + 0.05 * k) for k in range(F)]).astype(np.float32)
    uv = np.tile(r.uniform(0, 1, (1, N, 2)).astype(np.float32), (F, 1, 1))
    faces = [r.integers(0, N, (2 * N, 3)).astype(np.int32) for _ in range(F)]
    return GeometryFrameSet(pos, uv, np.full(F, N), faces)


def test_geometry_sequence_roundtrip():
    fs = _frames()
    codec = GeometrySequenceCodec(position_bits=11, uv_bits=10)
    blobs = codec.encode(fs)
    assert len(blobs) == 4
    dec = codec.decode(blobs)
    n = fs.positions.shape[1]
    for i in range(4):
        step = float(
            (fs.positions[i].max(0) - fs.positions[i].min(0)).max()
        ) / 2047
        assert np.abs(dec.positions[i, :n] - fs.positions[i]).max() <= step
        np.testing.assert_array_equal(dec.faces[i], fs.faces[i])


def test_geometry_sequence_ragged():
    fs = _frames()
    fs.counts = np.array([2000, 1500, 1000, 2000])
    codec = GeometrySequenceCodec()
    dec = codec.decode(codec.encode(fs))
    assert list(dec.counts) == [2000, 1500, 1000, 2000]
    # short frames reconstruct their valid prefix
    assert (
        np.abs(dec.positions[1, :1500] - fs.positions[1, :1500]).max() < 0.01
    )


def test_etc1_block_quality_gradient():
    r = np.random.default_rng(1)
    h = w = 32
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([(xx * 8) % 256, (yy * 8) % 256, 128 + 0 * xx], -1).astype(np.uint8)
    blocks = image_to_blocks(np.asarray(img))
    words = encode_etc1_blocks(blocks)
    out = np.asarray(blocks_to_image(decode_etc1_blocks(words), h, w))
    mse = np.mean((out.astype(float) - img) ** 2)
    psnr = 10 * np.log10(255**2 / mse)
    assert psnr > 30.0


def test_etc1_payload_endianness():
    r = np.random.default_rng(2)
    words = r.integers(0, 2**32, (7, 2), dtype=np.uint32)
    p = pack_etc1_payload(words)
    assert len(p) == 56
    # big-endian: first byte is the MSB of word1
    assert p[0] == words[0, 0] >> 24
    np.testing.assert_array_equal(unpack_etc1_payload(p), words)


def test_texture_segment_ktx2_roundtrip():
    # Channel-correlated noise (gray + small tint), representative of real
    # textures. Independent per-channel noise is NOT a valid quality probe
    # for ETC1: its per-pixel modifier is shared across RGB, so even an
    # ideal encoder (continuous base + continuous shared modifier) has a
    # mean-abs-error floor of E|u_c - mean_c(u)| ≈ 7.8 on uniform(100,140)
    # iid channels — the round-1 <6 bound was mathematically unreachable.
    r = np.random.default_rng(3)
    gray = r.uniform(0, 1, (5, 64, 64, 1)) * 40 + 100
    tint = r.uniform(-1, 1, (5, 64, 64, 3)) * 4
    frames = np.clip(gray + tint, 0, 255).astype(np.uint8)
    codec = TextureSequenceCodec(sequence_size=5)
    blob = codec.encode_segment(frames)
    f = read_ktx2(blob)
    assert f.header.layer_count == 5
    assert f.header.vk_format == 147  # ETC2 RGB
    out = codec.decode_segment(f)
    assert out.shape == frames.shape
    assert np.abs(out.astype(int) - frames.astype(int)).mean() < 6


def test_codebook_kmeans_monotone():
    import jax.numpy as jnp

    from uvol_tpu.models.codebook import kmeans_update

    r = np.random.default_rng(4)
    blocks = jnp.asarray(r.normal(size=(4096, 16)) * 50 + 128, jnp.float32)
    cb = jnp.asarray(r.uniform(0, 255, (32, 16)), jnp.float32)
    d_prev = np.inf
    for _ in range(4):
        cb, d = kmeans_update(blocks, cb)
        d = float(d)
        assert d <= d_prev + 1e-3
        d_prev = d


def test_encode_bucketed_ragged_matches_and_saves_padding():
    """encode_bucketed: ragged frames produce byte-identical blobs to a
    single-frame encode of each, and the buckets pad far less than one
    sequence-max batch."""
    import numpy as np

    from uvol_tpu.models.sequence import GeometryFrameSet, GeometrySequenceCodec
    from uvol_tpu.parallel.mesh import bucket_frames_by_count

    r = np.random.default_rng(3)
    counts = np.array([100, 120, 2000, 110, 1900, 130, 2100, 105])
    positions = [r.normal(size=(c, 3)).astype(np.float32) for c in counts]
    uvs = [r.uniform(size=(c, 2)).astype(np.float32) for c in counts]
    faces = [
        np.stack([np.arange(c - 2), np.arange(1, c - 1), np.arange(2, c)], 1)
        .astype(np.int32)
        for c in counts
    ]
    codec = GeometrySequenceCodec()
    got = codec.encode_bucketed(positions, uvs, faces)

    for i, c in enumerate(counts):
        fs = GeometryFrameSet(
            positions[i][None], uvs[i][None],
            np.array([c]), [faces[i]],
        )
        (ref,) = codec.encode(fs)
        assert got[i] == ref, i

    # padded-element accounting: buckets vs one max-padded batch
    buckets = bucket_frames_by_count(counts)
    bucketed = sum(len(b) * int(counts[b].max()) for b in buckets)
    single = len(counts) * int(counts.max())
    assert bucketed < single * 0.7, (bucketed, single)


@pytest.mark.parametrize("width", [128, 40, 136])  # nbx = 32, 10, 34
def test_texture_codec_words_equal_per_block_encode(width):
    """The codec's [2, L*nb] device word planes hold exactly the words of
    the per-block encoder, frame-major, whatever the row width."""
    import jax.numpy as jnp

    r = np.random.default_rng(width)
    frames = r.integers(0, 256, (3, 8, width, 3)).astype(np.uint8)
    codec = TextureSequenceCodec(sequence_size=3)
    words2 = np.asarray(codec._encode(jnp.asarray(frames)))
    want = np.stack(
        [np.asarray(encode_etc1_blocks(image_to_blocks(f))) for f in frames]
    )  # [L, nb, 2] uint32
    np.testing.assert_array_equal(pack_words2(words2, 3), want)
    blob = codec.encode_segment(frames)
    np.testing.assert_array_equal(
        codec.decode_segment(read_ktx2(blob)),
        np.stack([blocks_to_image(decode_etc1_blocks(w), 8, width) for w in want]),
    )


def test_pack_words2_roundtrip():
    r = np.random.default_rng(11)
    words = r.integers(0, 2**32, (4, 37, 2), dtype=np.uint64).astype(np.uint32)
    planes = unpack_words2(words)
    assert planes.shape == (2, 4 * 37) and planes.dtype == np.int32
    np.testing.assert_array_equal(planes[1, 37], words[1, 0, 1].astype(np.int32))
    back = pack_words2(planes, 4)
    assert back.dtype == np.uint32 and back.flags.c_contiguous
    np.testing.assert_array_equal(back, words)
