"""Command-line tools, the port of ``spiht_tpu/cli.py``: encode/decode one
image, stream files, batch encode, rate plan, rate-distortion sweep and the
progressive-decode GIF.

  python -m spiht_tpu_torch.cli encode-decode IMAGE [--bpp B] [--level L] ...
  python -m spiht_tpu_torch.cli progressive IMAGE OUT.gif [--frames N] ...

The flags, defaults, stream-file format and printed lines are the JAX
package's, with two differences: ``--backend`` takes 'torch' (the torch
transform on the device; 'jax' is the same choice), and ``--device``
names the device, the CUDA card by default ('cpu' runs the kernels' plain
versions). Each subcommand's body after ``imload`` is a function on an
array (``run_encode_decode``, ``run_encode``, ``run_decode``,
``run_batch``, ``run_plan``, ``run_sweep``, ``run_progressive``) taking
the parsed arguments (``build_parser().parse_args``), so it runs where
no image library is installed.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from collections import defaultdict

import numpy as np

from . import transform
from .codec import api
from .settings import EncodingResult, SpihtSettings
from .utils import imload, imsave
from .wavelets.geometry import get_slices_and_h_w


def _settings_from_args(args) -> SpihtSettings:
    pcs = None
    if args.per_channel_quant_scales:
        pcs = [float(v) for v in args.per_channel_quant_scales.split(",")]
    return SpihtSettings(
        wavelet=args.wavelet,
        quantization_scale=args.quantization_scale,
        mode=args.mode,
        color_model=args.color_model,
        per_channel_quant_scales=pcs,
    )


def _auto_level(h: int, w: int) -> int:
    """Reference auto-level: floor(min(log2(h/8), log2(w/8)))."""
    return int(math.floor(min(math.log2(h / 8), math.log2(w / 8))))


def _add_codec_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--wavelet", default="bior2.2")
    p.add_argument("--quantization-scale", type=float, default=50.0)
    p.add_argument("--mode", default="reflect")
    p.add_argument("--color-model", default=None)
    p.add_argument(
        "--per-channel-quant-scales",
        default=None,
        help="comma-separated, e.g. '100,20,20'",
    )
    p.add_argument("--level", type=int, default=None)
    p.add_argument("--bpp", type=float, default=1.0)
    p.add_argument(
        "--backend",
        choices=["auto", "native", "torch", "jax", "numpy", "device"],
        default="native",
        help="transform backend; 'native' (C++ f64 on the host, default), "
        "'torch' or its alias 'jax' (the torch transform on --device), "
        "'numpy' (trusted reference), 'auto' (SPIHT_TPU_TRANSFORM), "
        "'device' (the whole codec on --device: encode_image_device / "
        "decode_image_device, and encode_images_device for batch)",
    )
    p.add_argument(
        "--device", default=None,
        help="torch device of the bit machines and the torch transform; "
        "default: the CUDA card ('cpu' runs the kernels' plain versions)",
    )
    p.add_argument("--stats", action="store_true",
                   help="print per-stage timings and bit-plane histogram")


def _apply_backend(args) -> None:
    if args.backend == "device":
        return  # the on-device calls dispatch explicitly
    if args.backend != "auto":
        transform._BACKEND = args.backend


def _bpp_ok(args) -> bool:
    if args.bpp <= 0:
        print("error: --bpp must be > 0", file=sys.stderr)
        return False
    return True


def _level(args, h: int, w: int) -> int:
    return args.level if args.level is not None else _auto_level(h, w)


def run_encode_decode(image: np.ndarray, args):
    """Encode and decode one (C,H,W) image; prints the size, geometry and
    PSNR lines. Returns (EncodingResult, reconstruction cropped to
    (C,H,W))."""
    _apply_backend(args)
    c, h, w = image.shape
    settings = _settings_from_args(args)
    level = _level(args, h, w)
    max_bits = round(args.bpp * h * w)
    dev = args.device

    t0 = time.perf_counter()
    if args.backend == "device":
        er = api.encode_image_device(
            image, settings, level=level, max_bits=max_bits, device=dev
        )
    else:
        er = api.encode_image(
            image, settings, level=level, max_bits=max_bits, device=dev
        )
    t_enc = time.perf_counter() - t0
    nbytes = len(er.encoded_bytes)
    print(f"encoded {c}x{h}x{w} at level={level}: {nbytes} bytes "
          f"({nbytes*8/(h*w):.4f} bpp) in {t_enc*1e3:.1f} ms")

    slices, enc_h, enc_w = get_slices_and_h_w(h, w, settings, level)
    print(f"coeff array {enc_h}x{enc_w}, ll "
          f"{slices[0][1].stop}x{slices[0][2].stop}, max_n={er.max_n}")

    t0 = time.perf_counter()
    if args.backend == "device":
        rec = api.decode_image_device(er, settings, device=dev).cpu().numpy()
    else:
        rec = api.decode_image(er, settings, device=dev)
    t_dec = time.perf_counter() - t0
    rec_c = rec[..., :h, :w]
    mean_l2 = float(np.mean((rec_c - image) ** 2))
    mse = np.mean((np.clip(rec_c, 0, 1) - image) ** 2)
    psnr = 10 * math.log10(1.0 / mse) if mse > 0 else float("inf")
    print(f"decoded in {t_dec*1e3:.1f} ms; mean L2 {mean_l2:.3e}; "
          f"PSNR {psnr:.2f} dB")

    if args.stats:
        from . import metrics

        st = metrics.encode_stats(image, er, t_enc, reconstruction=rec_c)
        print(st.to_json())
        hist = metrics.bits_per_plane(er, settings, device=dev)
        print("bits per plane:",
              {n: hist[n] for n in sorted(hist, reverse=True)})
    return er, rec_c


def cmd_encode_decode(args) -> int:
    if not _bpp_ok(args):
        return 2
    _, rec_c = run_encode_decode(imload(args.image), args)
    if args.out:
        imsave(args.out, rec_c)
        print(f"wrote {args.out}")
    return 0


def _write_stream(path: str, er) -> None:
    """Container file: one JSON header line + raw stream bytes.

    The header carries the out-of-band framing (EncodingResult fields);
    codec settings remain a pre-shared contract, as in the reference.
    """
    d = er.to_dict()
    data = d.pop("encoding_result_encoded_bytes")
    with open(path, "wb") as f:
        f.write(json.dumps(d).encode() + b"\n")
        f.write(data)


def _read_stream(path: str):
    with open(path, "rb") as f:
        header = json.loads(f.readline().decode())
        data = f.read()
    header["encoding_result_encoded_bytes"] = data
    return EncodingResult.from_dict(header)


def run_encode(image: np.ndarray, args) -> EncodingResult:
    """Encode one (C,H,W) image to the stream file ``args.out``."""
    _apply_backend(args)
    c, h, w = image.shape
    settings = _settings_from_args(args)
    t0 = time.perf_counter()
    er = api.encode_image(
        image, settings, level=_level(args, h, w),
        max_bits=round(args.bpp * h * w), device=args.device,
    )
    t_enc = time.perf_counter() - t0
    _write_stream(args.out, er)
    print(f"encoded {c}x{h}x{w} -> {args.out}: {len(er.encoded_bytes)} bytes "
          f"({len(er.encoded_bytes)*8/(h*w):.4f} bpp) in {t_enc*1e3:.1f} ms")
    print("note: decoding requires the same codec settings "
          "(they are a pre-shared contract, not stored in the stream)")
    return er


def cmd_encode(args) -> int:
    if not _bpp_ok(args):
        return 2
    run_encode(imload(args.image), args)
    return 0


def run_decode(er: EncodingResult, args):
    """Decode one stream to a (C,H,W) image cropped to (er.h, er.w);
    returns (image, seconds)."""
    _apply_backend(args)
    settings = _settings_from_args(args)
    t0 = time.perf_counter()
    rec = api.decode_image(er, settings, device=args.device)
    rec = rec[..., : er.h, : er.w]
    return rec, time.perf_counter() - t0


def cmd_decode(args) -> int:
    try:
        er = _read_stream(args.stream)
    except FileNotFoundError:
        print(f"error: no such stream file: {args.stream}", file=sys.stderr)
        return 2
    except (ValueError, KeyError):
        print(f"error: {args.stream} is not a spiht stream file",
              file=sys.stderr)
        return 2
    rec, t_dec = run_decode(er, args)
    imsave(args.out, np.clip(rec, 0, 1))
    print(f"decoded {er.c}x{er.h}x{er.w} from {args.stream} "
          f"in {t_dec*1e3:.1f} ms -> {args.out}")
    return 0


def run_batch(loaded, args) -> list:
    """Batch-encode [(path, (C,H,W) image)] to stream files in
    ``args.outdir``: backend 'device' sends same-shape groups through
    ``encode_images_device`` (kernel B4), anything else through
    ``encode_images`` (the host-scheduled batch codec). Per-image bit
    budgets follow --bpp at each image's own geometry. Returns the
    EncodingResults in input order."""
    _apply_backend(args)
    settings = _settings_from_args(args)
    os.makedirs(args.outdir, exist_ok=True)
    groups = defaultdict(list)
    for i, (_, im) in enumerate(loaded):
        groups[im.shape].append(i)
    results = [None] * len(loaded)
    t0 = time.perf_counter()
    for shape, idxs in groups.items():
        _, h, w = shape
        level = _level(args, h, w)
        ims = [loaded[i][1] for i in idxs]
        mb = round(args.bpp * h * w)
        if args.backend == "device":
            ers = api.encode_images_device(
                ims, settings, level=level, max_bits=mb, device=args.device
            )
        else:
            ers = api.encode_images(
                ims, settings, level=level, max_bits=mb, device=args.device
            )
        for i, er in zip(idxs, ers):
            results[i] = er
    t_enc = time.perf_counter() - t0
    total_px = 0
    # inputs from different directories can share a basename stem;
    # disambiguate so nothing is silently overwritten in --outdir
    seen: dict = {}
    for (path, im), er in zip(loaded, results):
        stem = os.path.splitext(os.path.basename(path))[0]
        n_prior = seen.get(stem, 0)
        seen[stem] = n_prior + 1
        if n_prior:
            stem = f"{stem}-{n_prior}"
        out_path = os.path.join(args.outdir, stem + ".spiht")
        _write_stream(out_path, er)
        total_px += im.shape[1] * im.shape[2]
        print(f"{path} -> {out_path}: {len(er.encoded_bytes)} bytes "
              f"({len(er.encoded_bytes)*8/(im.shape[1]*im.shape[2]):.4f} "
              f"bpp)")
    print(f"encoded {len(loaded)} images ({total_px/1e6:.2f} MP) in "
          f"{t_enc*1e3:.1f} ms = {total_px/1e6/t_enc:.2f} MP/s aggregate")
    return results


def cmd_batch(args) -> int:
    if not _bpp_ok(args):
        return 2
    loaded = []
    for path in args.images:
        try:
            loaded.append((path, imload(path)))
        except (FileNotFoundError, OSError) as e:
            print(f"error: cannot read {path}: {e}", file=sys.stderr)
            return 2
    run_batch(loaded, args)
    return 0


def run_plan(image: np.ndarray, args) -> dict:
    """Rate plan WITHOUT encoding: per-plane bit counts + budget cut (the
    port's planner on --device); prints it as one JSON line."""
    from .codec.planning import plan_image

    _apply_backend(args)
    h, w = image.shape[-2:]
    plan = plan_image(
        image, _settings_from_args(args), level=_level(args, h, w),
        max_bits=round(args.bpp * h * w), device=args.device,
    )
    plan["planned_bpp"] = plan["total_bits"] / (h * w)
    print(json.dumps(plan))
    return plan


def cmd_plan(args) -> int:
    run_plan(imload(args.image), args)
    return 0


def run_sweep(image: np.ndarray, args) -> list:
    """Rate-distortion sweep: encode at each of --bpps, decode, print one
    JSON line of ``metrics.encode_stats`` per point. Returns [(bpp,
    EncodingResult, EncodeStats)]."""
    from . import metrics

    _apply_backend(args)
    h, w = image.shape[-2:]
    settings = _settings_from_args(args)
    level = _level(args, h, w)
    out = []
    for bpp in [float(v) for v in args.bpps.split(",")]:
        t0 = time.perf_counter()
        er = api.encode_image(
            image, settings, level=level, max_bits=round(bpp * h * w),
            device=args.device,
        )
        t_enc = time.perf_counter() - t0
        rec = api.decode_image(er, settings, device=args.device)[..., :h, :w]
        st = metrics.encode_stats(image, er, t_enc, reconstruction=rec)
        print(st.to_json())
        out.append((bpp, er, st))
    return out


def cmd_sweep(args) -> int:
    run_sweep(imload(args.image), args)
    return 0


def run_progressive(er: EncodingResult, args):
    """Decode --frames byte-stream PREFIXES of ``er`` at increasing bpp,
    the embedded-stream property. Returns (frames, coeff_frames, nbytes):
    uint8 (H,W,C) or (H,W) arrays, the raw coefficient views
    (|coeffs|*75) when --coeff-out is set, and each frame's prefix
    length."""
    _apply_backend(args)
    settings = _settings_from_args(args)
    c, h, w = er.c, er.h, er.w
    total_bytes = len(er.encoded_bytes)
    frames, coeff_frames, sizes = [], [], []
    for f in range(1, args.frames + 1):
        nb = max(1, round(total_bytes * f / args.frames))
        partial = EncodingResult(
            er.encoded_bytes[:nb], er.h, er.w, er.c, er.max_n, er.level
        )
        rec = api.decode_image(partial, settings,
                               device=args.device)[..., :h, :w]
        arr = (np.clip(rec, 0, 1) * 255).astype(np.uint8)
        frames.append(np.moveaxis(arr, 0, -1) if c > 1 else arr[0])
        if getattr(args, "coeff_out", None):
            # raw coefficient-array visualization: |coeffs| * 75 clipped
            dec = api.decode_rec_array(partial, settings, device=args.device)
            vis = np.clip(
                np.abs(np.asarray(dec["rec_arr"], np.float64)) * 75.0,
                0, 255,
            ).astype(np.uint8)
            coeff_frames.append(np.moveaxis(vis, 0, -1) if c > 1 else vis[0])
        sizes.append(nb)
        print(f"frame {f}/{args.frames}: {nb} bytes "
              f"({nb*8/(h*w):.4f} bpp)", file=sys.stderr)
    return frames, coeff_frames, sizes


def _annotate(img, bpp):
    """Burned-in bpp overlay: red text top-left, PIL's default font scaled
    to the frame."""
    from PIL import ImageDraw, ImageFont

    img = img.convert("RGB") if img.mode != "RGB" else img
    try:
        font = ImageFont.load_default(size=max(img.height // 12, 10))
    except TypeError:  # older PIL: fixed-size bitmap font
        font = ImageFont.load_default()
    ImageDraw.Draw(img).text(
        (10, 10), f"BPP: {bpp:.4f}", (255, 0, 0), font=font
    )
    return img


def cmd_progressive(args) -> int:
    """Write the progressive decode as an animated GIF. The input may be an
    image (encoded once at --bpp first) or a saved .spiht stream file
    (decoded directly, no re-encoding)."""
    from PIL import Image

    if not _bpp_ok(args):
        return 2
    _apply_backend(args)
    if args.image.endswith(".spiht"):
        er = _read_stream(args.image)
    else:
        image = imload(args.image)
        h, w = image.shape[-2:]
        er = api.encode_image(
            image, _settings_from_args(args), level=_level(args, h, w),
            max_bits=round(args.bpp * h * w), device=args.device,
        )
    arrays, coeff_arrays, sizes = run_progressive(er, args)
    frames = []
    for arr, nb in zip(arrays, sizes):
        frame = Image.fromarray(arr)
        if getattr(args, "annotate", False):
            frame = _annotate(frame, nb * 8 / (er.h * er.w))
        frames.append(frame)
    frames[0].save(
        args.out,
        save_all=True,
        append_images=frames[1:],
        duration=args.duration,
        loop=0,
    )
    print(f"wrote {args.out} ({len(frames)} frames)")
    if coeff_arrays:
        coeff_frames = [Image.fromarray(a) for a in coeff_arrays]
        coeff_frames[0].save(
            args.coeff_out,
            save_all=True,
            append_images=coeff_frames[1:],
            duration=args.duration,
            loop=0,
        )
        print(f"wrote {args.coeff_out} (raw coefficient view)")
    if getattr(args, "mp4", None):
        # mp4 companion (cv2 mp4v plays everywhere)
        import cv2

        fps = max(1000.0 / max(args.duration, 1), 1.0)
        vw = cv2.VideoWriter(
            args.mp4, cv2.VideoWriter_fourcc(*"mp4v"), fps,
            (frames[0].width, frames[0].height),
        )
        if not vw.isOpened():
            print("error: cv2 VideoWriter failed to open mp4 output",
                  file=sys.stderr)
            return 2
        for fr in frames:
            rgb = np.asarray(fr.convert("RGB"))
            vw.write(rgb[:, :, ::-1])  # BGR
        vw.release()
        print(f"wrote {args.mp4} ({len(frames)} frames @ {fps:.1f} fps)")
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="spiht-tpu-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p1 = sub.add_parser("encode-decode", help="round-trip one image")
    p1.add_argument("image")
    p1.add_argument("--out", default=None, help="save reconstruction here")
    _add_codec_args(p1)
    p1.set_defaults(fn=cmd_encode_decode)

    p4 = sub.add_parser("encode", help="encode an image to a stream file")
    p4.add_argument("image")
    p4.add_argument("out")
    _add_codec_args(p4)
    p4.set_defaults(fn=cmd_encode)

    p5 = sub.add_parser("decode", help="decode a stream file to an image")
    p5.add_argument("stream")
    p5.add_argument("out")
    _add_codec_args(p5)
    p5.set_defaults(fn=cmd_decode)

    p7 = sub.add_parser(
        "batch", help="batch-encode many images to stream files"
    )
    p7.add_argument("images", nargs="+")
    p7.add_argument("--outdir", required=True,
                    help="directory for the .spiht stream files")
    _add_codec_args(p7)
    p7.set_defaults(fn=cmd_batch)

    p6 = sub.add_parser("plan", help="rate plan without encoding (JSON)")
    p6.add_argument("image")
    _add_codec_args(p6)
    p6.set_defaults(fn=cmd_plan)

    p3 = sub.add_parser("sweep", help="rate-distortion sweep (JSON lines)")
    p3.add_argument("image")
    p3.add_argument("--bpps", default="0.075,0.1,0.25,0.5,1.0")
    _add_codec_args(p3)
    p3.set_defaults(fn=cmd_sweep)

    p2 = sub.add_parser("progressive", help="progressive-decode GIF")
    p2.add_argument("image")
    p2.add_argument("out")
    p2.add_argument("--frames", type=int, default=24)
    p2.add_argument("--duration", type=int, default=120, help="ms per frame")
    p2.add_argument(
        "--coeff-out", default=None,
        help="also write the raw coefficient-array visualization GIF "
             "(|coeffs|*75)",
    )
    p2.add_argument(
        "--annotate", action="store_true",
        help="burn a 'BPP: x.xxxx' overlay into each frame",
    )
    p2.add_argument(
        "--mp4", default=None, metavar="OUT.mp4",
        help="also write the animation as an mp4 (cv2 mp4v)",
    )
    _add_codec_args(p2)
    p2.set_defaults(fn=cmd_progressive)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
