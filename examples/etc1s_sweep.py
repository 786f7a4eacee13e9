"""Full-corpus ETC1S rate/quality sweep (VERDICT r2 item 7).

For every liam `.ktx2` segment: decode the basisu file to RGBA (the only
available reference — the original PNGs are not in the corpus, so dB is
measured against basisu's own decode, same methodology as the round-2
spot numbers), re-encode with our ETC1S encoder, and record

    bytes_ours / bytes_basisu   (level payloads, apples-to-apples)
    PSNR(ours vs basisu RGBA)

Appends one JSON line per segment to `docs/etc1s_sweep.jsonl` (resumable)
and prints a summary. Runs on whatever JAX backend is up
(JAX_PLATFORMS=cpu forces host).
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from uvol_tpu.codecs.basis.etc1s_encode import encode_ktx2_etc1s
from uvol_tpu.codecs.basis.transcoder import transcode_ktx2_etc1s
from uvol_tpu.containers.ktx2 import read_ktx2, read_ktx2_file

LIAM = (
    "/root/reference/example/public/liam/output/"
    "texture_ktx2-fps30-1k_baseColor_default"
)
OUT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "docs",
    "etc1s_sweep.jsonl",
)


def payload_bytes(f) -> int:
    return sum(len(lv.data) for lv in f.levels) + (
        len(f.raw_sgd) if f.raw_sgd else 0
    )


def main() -> None:
    done = set()
    if os.path.exists(OUT):
        with open(OUT) as fh:
            for line in fh:
                try:
                    done.add(json.loads(line)["segment"])
                except (ValueError, KeyError):
                    pass
    segments = sorted(
        int(n.split(".")[0]) for n in os.listdir(LIAM) if n.endswith(".ktx2")
    )
    ratios, psnrs = [], []
    for seg in segments:
        if seg in done:
            continue
        path = os.path.join(LIAM, f"{seg:05d}.ktx2")
        raw = open(path, "rb").read()
        f = read_ktx2(raw)
        ref_rgba = np.asarray(transcode_ktx2_etc1s(f, "rgba"))
        # apples-to-apples: the basisu corpus files carry NO alpha
        # slices — passing RGBA would force dead constant-alpha slices
        # into every segment and inflate our side of the ratio
        src = ref_rgba
        if not any(
            d.alpha_slice_byte_length for d in f.basis_lz.image_descs
        ):
            src = np.ascontiguousarray(ref_rgba[..., :3])
        t0 = time.time()
        blob = encode_ktx2_etc1s(
            src, num_endpoints="auto", num_selectors="auto",
            delta_lambda=150.0,
        )
        enc_s = time.time() - t0
        ours = read_ktx2(blob)
        got = np.asarray(transcode_ktx2_etc1s(ours, "rgba"))
        nch = src.shape[-1]
        mse = (
            (got[..., :nch].astype(np.float64) - ref_rgba[..., :nch]) ** 2
        ).mean()
        psnr = 10 * np.log10(255**2 / max(mse, 1e-12))
        ratio = payload_bytes(ours) / payload_bytes(f)
        rec = {
            "segment": seg,
            "bytes_ours": payload_bytes(ours),
            "bytes_basisu": payload_bytes(f),
            "ratio": round(ratio, 4),
            "psnr_vs_basisu_decode_db": round(float(psnr), 2),
            "endpoints": int(ours.basis_lz.endpoint_count),
            "selectors": int(ours.basis_lz.selector_count),
            "encode_s": round(enc_s, 1),
        }
        with open(OUT, "a") as fh:
            fh.write(json.dumps(rec) + "\n")
        print(json.dumps(rec), flush=True)
        ratios.append(ratio)
        psnrs.append(psnr)
    if ratios:
        print(
            f"SUMMARY new={len(ratios)} ratio med={np.median(ratios):.3f} "
            f"max={max(ratios):.3f} psnr med={np.median(psnrs):.1f}",
            flush=True,
        )


def rate_pass() -> None:
    """Second pass: re-encode every segment whose first-pass ratio
    exceeded 1.0 through the rate-target ladder; records get a
    ratio_rate_targeted / psnr_rate_targeted_db update."""
    from uvol_tpu.codecs.basis.etc1s_encode import encode_ktx2_etc1s_rate_target

    recs = [json.loads(l) for l in open(OUT)]
    by_seg = {r["segment"]: r for r in recs}
    for seg, rec in sorted(by_seg.items()):
        if rec.get("ratio", 0) <= 1.0 or "ratio_rate_targeted" in rec:
            continue
        path = os.path.join(LIAM, f"{seg:05d}.ktx2")
        f = read_ktx2(open(path, "rb").read())
        ref_rgba = np.asarray(transcode_ktx2_etc1s(f, "rgba"))
        target = payload_bytes(f)
        t0 = time.time()
        blob = encode_ktx2_etc1s_rate_target(
            ref_rgba, target,
            payload_of=lambda b: payload_bytes(read_ktx2(b)),
        )
        ours = read_ktx2(blob)
        got = np.asarray(transcode_ktx2_etc1s(ours, "rgba"))
        mse = ((got.astype(np.float64) - ref_rgba) ** 2).mean()
        rec["ratio_rate_targeted"] = round(payload_bytes(ours) / target, 4)
        rec["psnr_rate_targeted_db"] = round(
            float(10 * np.log10(255**2 / max(mse, 1e-12))), 2
        )
        rec["rate_target_s"] = round(time.time() - t0, 1)
        with open(OUT, "w") as fh:
            for s in sorted(by_seg):
                fh.write(json.dumps(by_seg[s]) + "\n")
        print(json.dumps(rec), flush=True)


RD_OUT = os.path.join(
    os.path.dirname(OUT), "etc1s_rd_curves.jsonl"
)

#: quality ladder for the rate-distortion pass: (tag, encoder kwargs)
RD_LADDER = [
    ("q0", dict(num_endpoints=128, num_selectors=128,
                rdo_lambdas=(4.0, 5.0, 5.0))),
    ("q1", dict(num_endpoints=256, num_selectors=256)),
    ("q2", dict(num_endpoints=512, num_selectors=384)),
    ("q3", dict(num_endpoints=1024, num_selectors=512)),
    ("q4", dict(num_endpoints=1536, num_selectors=768)),
]


def rd_pass(segments=None) -> None:
    """Rate-distortion curves (VERDICT r3 item 8): encode each segment
    at the full quality ladder and record one (bytes, PSNR) point per
    rung, so 'matching basisu' can be read off at equal PSNR instead of
    matched-palette proxies. Appends JSON lines to etc1s_rd_curves.jsonl
    (resumable per segment)."""
    done = set()
    if os.path.exists(RD_OUT):
        with open(RD_OUT) as fh:
            for line in fh:
                try:
                    done.add(json.loads(line)["segment"])
                except (ValueError, KeyError):
                    pass
    if segments is None:
        segments = sorted(
            int(n.split(".")[0])
            for n in os.listdir(LIAM)
            if n.endswith(".ktx2")
        )
    for seg in segments:
        if seg in done:
            continue
        path = os.path.join(LIAM, f"{seg:05d}.ktx2")
        f = read_ktx2(open(path, "rb").read())
        ref_rgba = np.asarray(transcode_ktx2_etc1s(f, "rgba"))
        src = ref_rgba
        if not any(
            d.alpha_slice_byte_length for d in f.basis_lz.image_descs
        ):
            src = np.ascontiguousarray(ref_rgba[..., :3])
        nch = src.shape[-1]
        points = []
        for tag, kw in RD_LADDER:
            t0 = time.time()
            blob = encode_ktx2_etc1s(src, **kw)
            ours = read_ktx2(blob)
            got = np.asarray(transcode_ktx2_etc1s(ours, "rgba"))
            mse = (
                (got[..., :nch].astype(np.float64) - ref_rgba[..., :nch])
                ** 2
            ).mean()
            points.append(
                {
                    "q": tag,
                    "bytes": payload_bytes(ours),
                    "psnr_db": round(
                        float(10 * np.log10(255**2 / max(mse, 1e-12))), 2
                    ),
                    "s": round(time.time() - t0, 1),
                }
            )
        rec = {
            "segment": seg,
            "bytes_basisu": payload_bytes(f),
            "points": points,
        }
        with open(RD_OUT, "a") as fh:
            fh.write(json.dumps(rec) + "\n")
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    if "--rate-pass" in sys.argv:
        rate_pass()
    elif "--rd" in sys.argv:
        segs = [int(a) for a in sys.argv[2:] if a.isdigit()] or None
        rd_pass(segs)
    else:
        main()
