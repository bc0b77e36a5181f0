"""Console tools, mirroring the reference CLI suite plus new ones.

Reference parity (tool -> reference source):
  unlz4        -> tool_unlz4ada/unlz4ada.adb (per-frame SINGLE_FRAME
                  contexts; treats legacy MAYBE as frame end and
                  re-inits, so mixed legacy/modern concatenation works)
  unlz4-simple -> tool_unlz4ada_simple/unlz4ada_simple.adb (one
                  long-lived context for everything)
  lz4hdrinfo   -> tool_lz4hdrinfo/lz4hdrinfo.adb (frame-header dump;
                  field-for-field identical layout)
  xxhash32     -> tool_xxhash32ada/xxhash32ada.adb

New capabilities (no reference analog):
  lz4-compress   LZ4 frame writer (hash-chain encoder)
  lz4-bench      decode benchmark (host / device / sharded backends)

Invoke via ``python -m lz4tpu_torch.cli <tool> [args]``.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys

import numpy as np

from .constants import (
    MAGIC_LEGACY,
    MAGIC_MODERN,
    SKIPPABLE_HI,
    SKIPPABLE_LO,
    EndOfFrame,
    Reservation,
)
from .errors import Lz4Error, ada_img, hex8, hex32
from .stream import Decompressor

# the device of lz4-bench's device, sharded and pipeline backends: the
# card unless the environment asks for the CPU (LZ4TPU_DEVICE=cpu)
DEVICE_ENV = "LZ4TPU_DEVICE"


def _read_all_stdin() -> bytes:
    return sys.stdin.buffer.read()


def cmd_unlz4(args) -> int:
    """stdin -> stdout decompressor, one SINGLE_FRAME context per frame."""
    data = memoryview(_read_all_stdin())
    out = sys.stdout.buffer
    pos = 0
    while pos < len(data):
        if len(data) - pos < 7:
            print(
                "Partial frame detected. Unable to process all data",
                file=sys.stderr,
            )
            return 1
        arr = np.frombuffer(data[pos:], dtype=np.uint8)
        ctx, consumed = Decompressor.from_header(arr, Reservation.SINGLE_FRAME)
        # Loop until the frame *may* have ended: a legacy frame reports
        # MAYBE at every block boundary and the next bytes may be a new
        # frame needing different settings, so re-init there — exactly
        # the reference consumer's policy (reference:
        # tool_unlz4ada/unlz4ada.adb:92-103).
        eof = EndOfFrame.NO
        stall = 0
        while eof == EndOfFrame.NO and consumed < arr.size:
            got, produced = ctx.update(arr[consumed:])
            out.write(produced)
            consumed += got
            eof = ctx.end_of_frame
            stall = stall + 1 if got == 0 else 0
            if stall > 4:
                break
        if eof == EndOfFrame.NO:
            print(
                "End not signalled by library. Unable to process all data",
                file=sys.stderr,
            )
            return 1
        pos += consumed
    out.flush()
    return 0


def cmd_unlz4_simple(args) -> int:
    """stdin -> stdout with one long-lived default context."""
    data = np.frombuffer(_read_all_stdin(), dtype=np.uint8)
    out = sys.stdout.buffer
    ctx = Decompressor()
    pos = 0
    while pos < data.size:
        got, produced = ctx.update(data[pos:pos + 4096])
        out.write(produced)
        pos += got
    if ctx.end_of_frame == EndOfFrame.NO:
        print("Input ended mid-frame.", file=sys.stderr)
        return 1
    out.flush()
    return 0


def cmd_lz4hdrinfo(args) -> int:
    """Frame-header dump (field layout identical to the reference)."""
    raw = sys.stdin.buffer.read(64)
    print("lz4tpu LZ4 Header Info (reference-compatible field dump)")
    print("")
    if len(raw) < 7:
        print(
            "Partial frame detected. Unable to process all data",
            file=sys.stderr,
        )
        return 1
    b = np.frombuffer(raw, dtype=np.uint8)
    magic = int(b[0]) | (int(b[1]) << 8) | (int(b[2]) << 16) | (int(b[3]) << 24)

    def line(label, value):
        print(f"{label:<22s} = {value}")

    if magic == MAGIC_MODERN:
        flg, bd = int(b[4]), int(b[5])
        line("Declared Format", f"{hex32(magic)} (modern)")
        line("FLG", hex8(flg))
        line("    Version:64|128", hex8((flg & 0xC0) >> 6))
        line("    Block_Checksum:16", str(bool(flg & 0x10)).upper())
        line("    Content_Size:8", str(bool(flg & 0x08)).upper())
        line("    Content_Checksum:4", str(bool(flg & 0x04)).upper())
        line("    Reserved:2", str(bool(flg & 0x02)).upper())
        line("    Dictionary_ID:1", str(bool(flg & 0x01)).upper())
        line("BD", hex8(bd))
        line("    Has_Reserved", str(bool(bd & 0x8F)).upper())
        sizes = {4: "64 KiB", 5: "256 KiB", 6: "1 MiB", 7: "4 MiB"}
        code = (bd & 0x70) >> 4
        line("    Block_Max_Size", f"{sizes.get(code, 'INVALID')} ({hex8(code)})")
        cursor = 6
        if flg & 0x08:
            cs = int.from_bytes(raw[6:14], "little")
            line("Content_Size", ada_img(cs))
            cursor += 8
        if flg & 0x01:
            cursor += 4
        line("Header_Checksum", hex8(int(b[cursor])))
    elif magic == MAGIC_LEGACY:
        line("Declared Format", f"{hex32(magic)} (legacy)")
    elif SKIPPABLE_LO <= magic <= SKIPPABLE_HI:
        line("Declared Format", f"{hex32(magic)} (skippable)")
        cs = int.from_bytes(raw[4:8], "little")
        line("Content_Size", ada_img(cs))
    else:
        line("Declared Format", f"{hex32(magic)} (UNSUPPORTED)")
    return 0


def cmd_xxhash32(args) -> int:
    """xxh32(seed=0) of stdin, printed as hex."""
    from .xxh32 import XXHash32

    try:
        from .native import NativeXXH32, available

        h = NativeXXH32() if available() else XXHash32()
    except Exception:
        h = XXHash32()
    while True:
        chunk = sys.stdin.buffer.read(1 << 20)
        if not chunk:
            break
        h.update(chunk)
    print(f"0x{h.final():08x}")
    return 0


def cmd_compress(args) -> int:
    """Compress stdin into an LZ4 frame on stdout.

    Streams through :class:`lz4tpu_torch.Compressor` in constant memory;
    ``--content-size`` (total length goes in the header) and
    ``--legacy`` need the whole input and fall back to one-shot."""
    if args.content_size or args.legacy:
        from .api import compress

        frame = compress(
            _read_all_stdin(),
            block_max_code=args.block_max_code,
            content_checksum=not args.no_content_checksum,
            block_checksum=args.block_checksum,
            content_size=args.content_size,
            block_independence=args.block_independence,
            max_chain=args.max_chain,
            level=args.level,
            frame_format="legacy" if args.legacy else "modern",
        )
        sys.stdout.buffer.write(frame)
        sys.stdout.buffer.flush()
        return 0
    from .api import Compressor

    c = Compressor(
        block_max_code=args.block_max_code,
        content_checksum=not args.no_content_checksum,
        block_checksum=args.block_checksum,
        block_independence=args.block_independence,
        max_chain=args.max_chain,
        level=args.level,
    )
    while True:
        chunk = sys.stdin.buffer.read(1 << 20)
        if not chunk:
            break
        sys.stdout.buffer.write(c.update(chunk))
    sys.stdout.buffer.write(c.finish())
    sys.stdout.buffer.flush()
    return 0


@contextlib.contextmanager
def _trace(log_dir: str):
    """torch.profiler over the block (the card's kernels too where there
    is one), with the program's spans recorded (``lz4tpu_torch.*``
    ranges beside the card's operations), written as a Chrome trace to
    ``log_dir/trace.json`` however the block ends."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from .trace import recording

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=acts)
    prof.start()
    try:
        with recording():
            yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def cmd_bench(args) -> int:
    """Time decode throughput of files via a chosen backend."""
    with contextlib.ExitStack() as stack:
        if getattr(args, "profile", None):
            # host and device timeline trace (view with Perfetto or
            # chrome://tracing); ExitStack closes the trace on every exit
            # path, including bench-loop errors
            stack.enter_context(_trace(args.profile))
            stack.callback(
                lambda: print(
                    f"profiler trace written to {args.profile}",
                    file=sys.stderr,
                )
            )
        return _bench_files(args)


def _device() -> str:
    return os.environ.get(DEVICE_ENV, "cuda")


def _bench_files(args) -> int:
    import time

    from .api import decompress, decompress_host

    if getattr(args, "encode", False):
        return _bench_encode(args)

    total_in = total_out = 0.0
    t_total = 0.0
    for path in args.files:
        try:
            data = open(path, "rb").read()
        except OSError as exc:
            print(f"lz4-bench: {exc}", file=sys.stderr)
            return 1
        if args.backend == "pipeline":
            from .serve import DecodeSession

            with DecodeSession(device=_device()) as s:
                out = s.submit(data).result()  # warm caches
                t0 = time.time()
                for _ in range(args.reps):
                    out = s.decode_all([data] * 4)[-1]
                dt = (time.time() - t0) / (args.reps * 4)
        elif args.backend == "sharded":
            from .dist import decompress_sharded, make_mesh

            mesh = make_mesh(device=_device())
            decompress_sharded(data, mesh)  # warm
            t0 = time.time()
            for _ in range(args.reps):
                out = decompress_sharded(data, mesh)
            dt = (time.time() - t0) / args.reps
        elif args.backend == "host":
            decompress_host(data)
            t0 = time.time()
            for _ in range(args.reps):
                out = decompress_host(data)
            dt = (time.time() - t0) / args.reps
        elif args.backend == "device":
            from .pipeline import decompress_device

            decompress_device(data, device=_device())
            t0 = time.time()
            for _ in range(args.reps):
                out = decompress_device(data, device=_device())
            dt = (time.time() - t0) / args.reps
        else:
            decompress(data, backend=args.backend)
            t0 = time.time()
            for _ in range(args.reps):
                out = decompress(data, backend=args.backend)
            dt = (time.time() - t0) / args.reps
        total_in += len(data)
        total_out += len(out)
        t_total += dt
        print(
            f"{path}: {len(data)} -> {len(out)} B, {dt * 1e3:.2f} ms, "
            f"{len(out) / dt / 1e6:.1f} MB/s",
            file=sys.stderr,
        )
        if getattr(args, "stats", False) and args.backend in ("device", "auto"):
            from .pipeline import DecodeStats, decompress_device

            st = DecodeStats()
            decompress_device(data, stats=st, device=_device())
            print(
                f"  frames={st.n_frames} blocks={st.n_blocks} "
                f"chains={st.n_chains} seqs={st.n_seqs} "
                f"engines={st.engine_chains} bytes={st.engine_bytes}\n"
                f"  parse={st.parse_s * 1e3:.2f}ms scan={st.scan_s * 1e3:.2f}ms "
                f"plan={st.plan_s * 1e3:.2f}ms device={st.device_s * 1e3:.2f}ms "
                f"verify={st.verify_s * 1e3:.2f}ms",
                file=sys.stderr,
            )
            if st.device_codes:
                print(f"  dense_codes={st.dense_codes_s * 1e3:.2f}ms "
                      f"device_codes={st.device_codes}", file=sys.stderr)
            if st.arena_blocks:
                print(f"  arena_blocks={st.arena_blocks}", file=sys.stderr)
    if t_total:
        print(
            f"TOTAL: {total_out / t_total / 1e6:.1f} MB/s decompressed",
            file=sys.stderr,
        )
    return 0


def _bench_encode(args) -> int:
    """Encode throughput: times the three encoder paths on raw payload
    files and checks the round trip.  The device encoder's split —
    sorted-gram candidate generation on the device, byte-granular token
    emission on the host — is measured here so its device fraction is
    recorded, not guessed."""
    import time

    from .api import compress, decompress_host

    total = 0.0
    t_total = 0.0
    for path in args.files:
        try:
            data = open(path, "rb").read()
        except OSError as exc:
            print(f"lz4-bench: {exc}", file=sys.stderr)
            return 1
        if args.backend == "sharded":
            from .dist import compress_sharded, make_mesh

            mesh = make_mesh(device=_device())
            fn = lambda: compress_sharded(data, mesh)  # noqa: E731
        elif args.backend in ("device", "device-emit", "auto"):
            be = "device-emit" if args.backend == "device-emit" else "device"
            fn = lambda: compress(data, backend=be,  # noqa: E731
                                  device=_device())
        else:
            fn = lambda: compress(data, backend="host")  # noqa: E731
        frame = fn()   # warm caches
        if decompress_host(frame) != data:
            print(f"lz4-bench: {path}: round-trip mismatch",
                  file=sys.stderr)
            return 1
        t0 = time.time()
        for _ in range(args.reps):
            frame = fn()
        dt = (time.time() - t0) / args.reps
        total += len(data)
        t_total += dt
        print(
            f"{path}: {len(data)} -> {len(frame)} B "
            f"({len(frame) / max(len(data), 1):.3f}x), {dt * 1e3:.2f} ms, "
            f"{len(data) / dt / 1e6:.1f} MB/s encode",
            file=sys.stderr,
        )
    if t_total:
        print(f"TOTAL: {total / t_total / 1e6:.1f} MB/s compressed",
              file=sys.stderr)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="lz4tpu_torch", description=__doc__)
    sub = parser.add_subparsers(dest="tool", required=True)
    sub.add_parser("unlz4").set_defaults(fn=cmd_unlz4)
    sub.add_parser("unlz4-simple").set_defaults(fn=cmd_unlz4_simple)
    sub.add_parser("lz4hdrinfo").set_defaults(fn=cmd_lz4hdrinfo)
    sub.add_parser("xxhash32").set_defaults(fn=cmd_xxhash32)

    pc = sub.add_parser("lz4-compress")
    pc.add_argument("--block-max-code", type=int, default=7, choices=[4, 5, 6, 7])
    pc.add_argument("--no-content-checksum", action="store_true")
    pc.add_argument("--block-checksum", action="store_true")
    pc.add_argument("--content-size", action="store_true")
    pc.add_argument("--block-independence", action="store_true")
    pc.add_argument("--max-chain", type=int, default=64)
    pc.add_argument("--level", type=int, default=6,
                    help=">=10 selects the optimal parser")
    pc.add_argument("--legacy", action="store_true",
                    help="write the Legacy Frame Format")
    pc.set_defaults(fn=cmd_compress)

    pb = sub.add_parser("lz4-bench")
    pb.add_argument("files", nargs="+")
    pb.add_argument("--backend", default="host",
                    choices=["host", "device", "device-emit", "auto",
                             "sharded", "pipeline"])
    pb.add_argument("--encode", action="store_true",
                    help="measure compression instead of decompression"
                         " (files are raw payloads; encoder per"
                         " --backend: host hash-chain, device sorted-"
                         "gram candidates, sharded block-parallel)")
    pb.add_argument("--reps", type=int, default=3)
    pb.add_argument("--stats", action="store_true",
                    help="print DecodeStats counters (device/auto backends)")
    pb.add_argument("--profile", metavar="DIR",
                    help="write a torch.profiler trace of the run to DIR, "
                    "the program's spans (lz4tpu_torch.*) beside its "
                    "operations")
    pb.set_defaults(fn=cmd_bench)

    args = parser.parse_args(argv)
    try:
        return args.fn(args)
    except Lz4Error as exc:
        print(exc.ada_image(), file=sys.stderr)
        return 1


def _tool_main(tool: str):
    def run(argv=None) -> int:
        args = [tool] + list(sys.argv[1:] if argv is None else argv)
        return main(args)

    return run


# Entry points, one per tool, as the JAX package's console scripts have;
# each mirrors one of the reference's standalone binaries.  The wheel
# installs them as the JAX package's script names with ``-torch``
# appended (``unlz4tpu-torch``, ``lz4tpu-bench-torch``, ...); in a
# checkout, ``python -m lz4tpu_torch.cli <tool>`` runs the same.
main_unlz4 = _tool_main("unlz4")
main_unlz4_simple = _tool_main("unlz4-simple")
main_lz4hdrinfo = _tool_main("lz4hdrinfo")
main_xxhash32 = _tool_main("xxhash32")
main_compress = _tool_main("lz4-compress")
main_bench = _tool_main("lz4-bench")


if __name__ == "__main__":
    sys.exit(main())
