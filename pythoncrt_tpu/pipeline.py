"""Video render pipeline: decode -> device batches -> encode.

The reference's per-frame thread pool with in-order drain
(crt_filter.py:864-1150) becomes a host pipeline around one jitted
batched device step:

  decode thread -> bounded batch queue -> device step (async dispatch,
  persistence carry chained on device) -> async device->host copy ->
  encode thread

JAX's async dispatch overlaps the device compute of batch N with the host
decode of batch N+1 and the encode of batch N-1, so the device never
stalls on I/O (BASELINE.json north star). The persistence IIR lives
inside the device step; the host only threads the carry array through.
"""

from __future__ import annotations

import math
import os
import queue
import threading
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np

from . import perf
from .engine import CRTEngine
from .io import video as vio
from .params import EffectParams
from .text import overlay_for

DEFAULT_BATCH = 16


def _put_or_stop(q: queue.Queue, item, stop: threading.Event) -> bool:
    """Bounded put that rechecks the stop event, so a producer thread can
    never stay blocked forever when the consumer has bailed out."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.2)
            return True
        except queue.Full:
            continue
    return False


def _feeder(
    reader, batch_size: int, out_q: queue.Queue, stop: threading.Event,
    start_idx: int = 0, err: dict | None = None,
) -> None:
    """Decode thread: fill (B, H, W, 3) uint8 batch buffers.

    Frames are decoded straight into the batch buffer (read_into), so
    the host path is decoder-write -> device_put with no staging copies;
    parallel chunked readers hand over whole in-order batches.

    start_idx: absolute frame position of the reader's first frame
    (segment resume seeks the decoder, so no frames are dropped here);
    batch indices continue at the absolute position so phase / flicker /
    RNG keys are identical to an uninterrupted render.

    A decoder exception is recorded in err["decode"] (surfaced by
    process_video after the drain) rather than silently ending the
    stream as a fake EOF.
    """
    try:
        if hasattr(reader, "iter_batches"):
            for idx0, batch in reader.iter_batches(batch_size):
                if stop.is_set() or not _put_or_stop(out_q, (idx0, batch), stop):
                    break
            return
        fshape = getattr(reader, "frame_shape",
                         (reader.out_h, reader.out_w, 3))
        idx0 = start_idx
        while not stop.is_set():
            buf = np.empty((batch_size, *fshape), np.uint8)
            got = 0
            with perf.timed("io.decode"):
                while got < batch_size and reader.read_into(buf[got]):
                    got += 1
            if got == 0:
                break
            if not _put_or_stop(out_q, (idx0, buf[:got]), stop):
                break
            idx0 += got
            if got < batch_size:
                break
    except Exception as e:  # surfaced by the consumer, not a fake EOF
        if err is not None:
            err["decode"] = e
    finally:
        # The sentinel must not be droppable: the main loop blocks on
        # decode_q.get() until it sees None, so a 5s give-up here would
        # convert encoder backpressure into a permanent hang. The
        # stop-aware put bails out only when the consumer already quit.
        _put_or_stop(out_q, None, stop)


def _writer_loop(
    writer, in_q: queue.Queue, progress, total_frames: int, err: dict,
) -> None:
    written = 0
    while True:
        item = in_q.get()
        if item is None:
            break
        if "encode" in err:
            continue  # keep draining so the producer never blocks
        try:
            with perf.timed("io.encode"):
                for frame in item:
                    writer.write_frame(frame)
                    written += 1
        except Exception as e:  # ffmpeg child died, disk full, ...
            err["encode"] = e
            continue
        if progress is not None and total_frames > 0:
            try:
                progress(min(1.0, written / float(total_frames)))
            except Exception as e:
                # a raising progress callback must not kill the drain:
                # producers block on this queue, and with the thread dead
                # (and err unset) the render would hang forever. Mark the
                # clip failed and keep draining.
                err.setdefault("encode", e)


def _segment_writer_loop(
    store, seg_len: int, w: int, h: int, fps: float,
    start_seg: int, start_frames: int,
    in_q: queue.Queue, progress, total_frames: int,
    enc_kwargs: dict, box: dict, err: dict,
) -> None:
    """Encode thread, segment mode: rotate a fresh segment writer every
    seg_len frames; a completed segment commits (file close -> carry
    snapshot -> journal line) before the next opens. Items are
    (frames, carry_state_or_None); the sentinel ("eof",) commits the
    partial tail, ("abort",) leaves it unjournaled for the resume to
    re-render."""
    seg, written_in_seg, total_written = start_seg, 0, start_frames
    cur = None

    def close_seg(mark: bool, state=None) -> None:
        nonlocal cur, seg, written_in_seg
        if cur is None:
            return
        cur.close()
        if mark:
            store.mark_done(seg, written_in_seg, state)
            seg += 1
        cur, written_in_seg = None, 0

    while True:
        item = in_q.get()
        if item is None or isinstance(item[0], str):
            try:
                close_seg(mark=item is not None and item[0] == "eof"
                          and "encode" not in err)
            except Exception as e:
                err.setdefault("encode", e)
            break
        if "encode" in err:
            continue  # keep draining so the producer never blocks
        frames, state = item
        try:
            with perf.timed("io.encode"):
                for frame in frames:
                    if cur is None:
                        cur, gpu = vio.open_writer(
                            str(store.seg_path(seg)), w, h, fps, **enc_kwargs
                        )
                        box.setdefault("used_gpu", gpu)
                    cur.write_frame(frame)
                    written_in_seg += 1
                    total_written += 1
            # seg_len is batch-aligned, so boundaries land on item ends
            if written_in_seg >= seg_len:
                close_seg(mark=True, state=state)
        except Exception as e:
            err["encode"] = e
            continue
        if progress is not None and total_frames > 0:
            progress(min(1.0, total_written / float(total_frames)))
    box["segments"] = seg


def planar_pipe_gate(pipe_format: str) -> bool:
    """Single source of truth for the ffmpeg-gbrp planar fast-path
    eligibility (PCRT_NO_PLANAR=1 opts out). process_video and
    multiclip.process_videos must use the SAME gate — a drift here
    silently renders the batch path in a different layout than the
    single-clip path it must match bitwise."""
    return (pipe_format == "rgb24"
            and vio.find_ffmpeg() is not None
            and os.environ.get("PCRT_NO_PLANAR") != "1")


def process_video(
    input_path: str | Path,
    output_path: str | Path,
    params: EffectParams,
    *,
    width: Optional[int] = None,
    height: Optional[int] = None,
    fps: Optional[float] = None,
    crf: int = 18,
    target_bitrate_kbps: int = 0,
    gpu: bool = False,
    nvenc_preset: str = "p4",
    encoder_preference: str = "auto",
    decoder_preference: str = "auto",
    batch_size: int = DEFAULT_BATCH,
    engine_mode: str = "export",
    rng: str = "native",
    seed: int = 0,
    assoc_scan: bool = False,
    precision: str = "exact",
    pipe_format: str = "rgb24",
    sharding: str = "auto",
    devices: int = 0,
    decode_workers: int = 1,
    steps_per_call: int = 0,
    segment_frames: int = 0,
    progress_cb: Optional[Callable[[float], None]] = None,
    report: bool = True,
    profile_dir: Optional[str] = None,
    _fail_after_frames: int = 0,
) -> bool:
    """Render ``input_path`` through the effect chain to ``output_path``.

    Parameter semantics mirror reference process_video (crt_filter.py:864-912):
    width/height/fps of None/0 keep the source values; returns used_gpu.

    sharding: "auto" shards each batch's frame axis across all local
    devices when more than one is visible (persistence carry crosses
    shard boundaries on-device); "none" forces single-device.
    devices: cap on how many devices "auto" shards across (0 = all).

    steps_per_call: batch chunks scanned inside ONE device dispatch
    (engine/ShardedCRTEngine process_stack) — amortizes per-dispatch
    launch overhead while the per-iteration working set stays one
    batch. 0 = auto (4, single-device and sharded alike; 1 when
    writing segments, whose journal snapshots the carry per batch —
    an explicit value > 1 is forced to 1 there, with a notice).

    segment_frames > 0 enables intra-render checkpointing: output is
    written as batch-aligned segments with a resume journal (see
    segments.py) and assembled at the end; re-running the same command
    after a crash resumes from the first unfinished segment.
    _fail_after_frames is a test hook that injects a crash.
    """
    input_path, output_path = Path(input_path), Path(output_path)
    info = vio.probe_clip(input_path)
    out_w = int(width) if width else info.width
    out_h = int(height) if height else info.height
    fps_out = float(fps) if fps and fps > 0 else (info.fps or 24.0)
    total_frames = max(1, int(math.ceil(info.duration * fps_out)))

    perf.perf_reset()
    t_start = time.perf_counter()

    audio_path = vio.extract_audio(input_path)
    output_path.parent.mkdir(parents=True, exist_ok=True)

    text_rgba = overlay_for(out_w, out_h, params.text)
    with perf.timed("fx.compile"):
        will_shard = False
        if sharding == "auto":
            import jax

            ndev = len(jax.devices())
            if devices > 0:
                ndev = min(ndev, devices)
            will_shard = ndev > 1 and batch_size % ndev == 0
        elif sharding not in ("none",):
            raise ValueError(f"sharding must be 'auto' or 'none', got {sharding!r}")
        # Planar pipes: when ffmpeg pipes both sides and the engine
        # resolves a planar layout, decode gbrp planes straight into it
        # and pipe planar output back to the encoder with no host
        # repack; layout="auto" resolves to NHWC, which keeps rgb24
        # pipes. ShardedCRTEngine is layout-agnostic (frames shard on
        # axis 0 either way).
        want_planar = planar_pipe_gate(pipe_format)
        eng = CRTEngine(
            params, out_h, out_w, fps_out,
            engine=engine_mode, rng=rng, seed=seed,
            text_rgba=text_rgba, assoc_scan=assoc_scan, precision=precision,
            layout="auto" if want_planar else "nhwc",
            channel_order="gbr" if want_planar else "rgb",
        )
        planar = eng.layout == "planar"
        runner = eng
        if will_shard:
            from .parallel import ShardedCRTEngine, make_mesh

            runner = ShardedCRTEngine(eng, make_mesh(ndev))
    pipe_eff = "gbrp" if planar else pipe_format
    out_pix_fmt = "gbrp" if planar else "rgb24"

    segmented = segment_frames > 0
    spc = int(steps_per_call)
    if spc <= 0:
        # auto: one dispatch per 8 batches at <=1080p (the super-batch
        # holds spc*B decoded frames in host RAM — ~1.6 GB at 1080p
        # B=32; 4 above 1080p where it would be 6+ GB), for both
        # single-device and sharded runs (ShardedCRTEngine.process_stack
        # scans chunks under one shard_map). Keep per-batch dispatch
        # when segmented (the journal snapshots the carry per batch).
        spc = 1 if segmented else (8 if out_h * out_w <= 1920 * 1080 else 4)
    elif spc > 1 and segmented:
        # an explicit request can't be honored: segment boundaries need
        # a carry snapshot per batch. Say so instead of silently
        # clamping (advisor r3).
        print("steps-per-call > 1 is forced to 1 under --segment-frames "
              "(the journal snapshots the carry per batch)", flush=True)
        spc = 1
    writer = None
    used_gpu = False
    skip = 0
    state = None
    seg_box: dict = {}
    store = None
    seg_len = 0
    if segmented:
        import dataclasses

        from .segments import SegmentStore

        # batch-aligned segment length: boundaries land on batch ends so
        # the carry snapshot accompanies the batch that closes a segment
        seg_len = max(batch_size, -(-int(segment_frames) // batch_size) * batch_size)
        sig = {
            "w": out_w, "h": out_h, "fps": fps_out, "seg": seg_len,
            "engine": engine_mode, "rng": rng, "seed": seed,
            "precision": precision,
            # carry snapshots are layout-shaped; a layout change between
            # runs must invalidate the journal rather than resume into
            # mismatched state arrays
            "layout": eng.layout,
            "params": dataclasses.asdict(params.clamped()),
        }
        store = SegmentStore(output_path, sig)
        next_seg, skip, seg_state = store.resume()
        store.begin(next_seg)
        if seg_state is not None:
            import jax.numpy as jnp

            state = jnp.asarray(seg_state)
        enc_kwargs = dict(
            encoder_preference=encoder_preference, gpu=gpu, crf=crf,
            bitrate_kbps=target_bitrate_kbps, nvenc_preset=nvenc_preset,
            audio_path=None,  # audio is muxed at merge time
            pix_fmt=out_pix_fmt,
        )
    else:
        writer, used_gpu = vio.open_writer(
            str(output_path), out_w, out_h, fps_out,
            encoder_preference=encoder_preference, gpu=gpu, crf=crf,
            bitrate_kbps=target_bitrate_kbps, nvenc_preset=nvenc_preset,
            audio_path=audio_path, pix_fmt=out_pix_fmt,
        )

    # opened after the resume point is known: the decoder seeks straight
    # to the first unrendered frame (O(remaining) resume)
    if decode_workers > 1 and info.duration <= 0:
        # unknown/zero duration: the chunk partition needs a frame
        # count; the sequential reader just reads to EOF
        decode_workers = 1
    if decode_workers > 1:
        # spc > 1: chunk/batch granularity is the super-batch, so the
        # feeder's iter_batches(feed_bs) contract holds (see below)
        reader = vio.ChunkedParallelReader(
            str(input_path), out_w, out_h, fps_out, total_frames,
            spc * batch_size,
            workers=decode_workers, decoder_preference=decoder_preference,
            pipe_format=pipe_eff, start_frame=skip,
        )
    else:
        reader = vio.open_reader(
            str(input_path), out_w, out_h, fps_out, decoder_preference,
            pipe_eff, start_frame=skip,
        )

    # spc > 1: the feeder fills SUPER-batches of spc*batch_size that the
    # dispatch loop view-reshapes into (spc, B, ...) stacks — no extra
    # host copy; the queue bound shrinks so host RAM held in flight
    # stays ~constant
    feed_bs = spc * batch_size
    decode_q: queue.Queue = queue.Queue(maxsize=max(2, 4 // spc))
    encode_q: queue.Queue = queue.Queue(maxsize=4)
    stop = threading.Event()
    err: dict = {}
    t_dec = threading.Thread(
        target=_feeder, args=(reader, feed_bs, decode_q, stop, skip, err),
        daemon=True,
    )
    if segmented:
        t_enc = threading.Thread(
            target=_segment_writer_loop,
            args=(store, seg_len, out_w, out_h, fps_out, next_seg, skip,
                  encode_q, progress_cb, total_frames, enc_kwargs, seg_box, err),
            daemon=True,
        )
    else:
        t_enc = threading.Thread(
            target=_writer_loop,
            args=(writer, encode_q, progress_cb, total_frames, err),
            daemon=True,
        )
    t_dec.start()
    t_enc.start()

    frames_done = skip
    pending = None  # device batch in flight
    profiler_ctx = None
    if profile_dir:
        # xprof trace of the device work (SURVEY.md §5: tracing parity);
        # view with tensorboard or xprof.
        import jax

        profiler_ctx = jax.profiler.trace(profile_dir)
        profiler_ctx.__enter__()
    clean = False

    def enqueue(p):
        with perf.timed("fx.device_wait"):
            if segmented:
                out_dev, st = p
                item = (np.asarray(out_dev), None if st is None else np.asarray(st))
            else:
                item = np.asarray(p)
                if item.ndim == 5:  # (spc, B, ...) multi-step stack
                    item = item.reshape((-1,) + item.shape[2:])
        # the writer thread drains even after a failure, so this cannot
        # block forever; surface its recorded error in the main thread
        while True:
            if "encode" in err:
                raise RuntimeError("encode failed") from err["encode"]
            if not t_enc.is_alive():
                raise RuntimeError("encoder thread died")
            try:
                encode_q.put(item, timeout=1.0)
                return
            except queue.Full:
                continue

    try:
        try:
            while True:
                item = decode_q.get()
                if item is None:
                    break
                idx0, sb = item
                if spc > 1 and sb.shape[0] == feed_bs:
                    # full super-batch: one multi-step dispatch covers
                    # spc chunks (bitwise == spc process() calls); the
                    # sharded runner's process_stack scans under the
                    # same shard_map
                    with perf.timed("fx.dispatch"):
                        stack = sb.reshape((spc, batch_size) + sb.shape[1:])
                        idxs = np.arange(idx0, idx0 + feed_bs)
                        out_dev, state = runner.process_stack(
                            stack, idxs.reshape(spc, batch_size), state=state)
                        out_dev.copy_to_host_async()
                    if pending is not None:
                        enqueue(pending)
                    pending = out_dev
                    frames_done += feed_bs
                    if _fail_after_frames and frames_done - skip >= _fail_after_frames:
                        raise RuntimeError("injected failure (test hook)")
                    continue
                # per-batch path: spc == 1, or a short super-batch tail
                # sliced back into plain batches (views, no copies)
                for off in range(0, sb.shape[0], batch_size):
                    batch = sb[off:off + batch_size]
                    i0 = idx0 + off
                    with perf.timed("fx.dispatch"):
                        # the sharded runner needs mesh-divisible batches;
                        # the stream tail falls back to the single-device
                        # engine
                        use = runner if batch.shape[0] == batch_size else eng
                        out_dev, state = use.process(
                            batch, np.arange(i0, i0 + batch.shape[0]), state=state
                        )
                        out_dev.copy_to_host_async()
                    if pending is not None:
                        enqueue(pending)
                    if segmented:
                        # a batch that closes a segment carries the carry
                        # snapshot its journal line commits with
                        end = i0 + batch.shape[0]
                        at_boundary = end % seg_len == 0 and eng.params.persistence_on
                        pending = (out_dev, state if at_boundary else None)
                    else:
                        pending = out_dev
                    frames_done += batch.shape[0]
                    if _fail_after_frames and frames_done - skip >= _fail_after_frames:
                        raise RuntimeError("injected failure (test hook)")
            if pending is not None:
                enqueue(pending)
            clean = True
        finally:
            if profiler_ctx is not None:
                profiler_ctx.__exit__(None, None, None)
            stop.set()
            try:
                encode_q.put(
                    (("eof",) if clean else ("abort",)) if segmented else None,
                    timeout=30,
                )
            except queue.Full:
                pass
            t_enc.join(timeout=120)
            reader.close()
            if writer is not None:
                try:
                    writer.close()
                except Exception as e:
                    # surfaced via the err check below on the clean path;
                    # never masks an in-flight pipeline exception
                    err.setdefault("encode", e)
        if "encode" in err:
            raise RuntimeError("encode failed") from err["encode"]
        if "decode" in err:
            raise RuntimeError("decode failed") from err["decode"]
        if segmented and clean:
            with perf.timed("io.merge"):
                store.merge(
                    seg_box.get("segments", next_seg), out_w, out_h, fps_out,
                    audio_path=audio_path,
                    # the re-encode fallback must honor the user's codec
                    # settings, not re-encode at defaults
                    enc_kwargs=dict(
                        encoder_preference=encoder_preference, gpu=gpu,
                        crf=crf, bitrate_kbps=target_bitrate_kbps,
                        nvenc_preset=nvenc_preset),
                )
            used_gpu = bool(seg_box.get("used_gpu", False))
    finally:
        if audio_path:
            try:
                os.unlink(audio_path)
            except OSError:
                pass

    total_seconds = time.perf_counter() - t_start
    if report:
        # report only the frames RENDERED THIS RUN: frames_done starts at
        # `skip` on a segmented resume, and counting the previously-
        # journaled frames would inflate the fps figure
        perf.perf_report(total_frames=frames_done - skip,
                         total_seconds=total_seconds)
    if progress_cb is not None:
        progress_cb(1.0)
    return used_gpu
