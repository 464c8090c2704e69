"""Host media I/O: decode, encode, codec selection, capability probes.

Codecs stay on the host (SURVEY.md §2.2), as in the reference, which
delegates to ffmpeg/OpenCV binaries (crt_filter.py:469-529 raw reader,
:938-1014 codec selection). Two backends, probed at runtime with
tier-by-tier fallback (the reference's probe-and-fallback semantics,
:141-204, :1024-1032):

1. An ffmpeg executable (FFMPEG_BINARY env, imageio-ffmpeg, or PATH):
   rawvideo pipes for zero-copy decode/encode, x264/NVENC/AMF parameter
   mapping, audio extract/mux.
2. OpenCV's built-in VideoCapture/VideoWriter (optional; imported only
   when used): video-only fallback; audio degrades to mute output
   exactly like the reference's audio-failure path
   (crt_filter.py:934-935).
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

from .. import perf

# Failed fourcc probes (e.g. avc1 -> missing h264_v4l2m2m) make libav log
# ERROR lines through OpenCV's FFMPEG backend; quiet them unless the user
# already configured a level.
os.environ.setdefault("OPENCV_FFMPEG_LOGLEVEL", "-8")


# --------------------------------------------------------------------------
# ffmpeg binary discovery + capability probes
# --------------------------------------------------------------------------

def find_ffmpeg() -> Optional[str]:
    cand = os.environ.get("FFMPEG_BINARY")
    if cand and os.path.isfile(cand):
        return cand
    try:
        import imageio_ffmpeg

        return imageio_ffmpeg.get_ffmpeg_exe()
    except Exception:
        pass
    return shutil.which("ffmpeg")


_PROBE_CACHE: dict[tuple, bool] = {}


def _probe_encoder(codec: str) -> bool:
    """Tiny lavfi test encode to the null muxer; returncode 0 => usable
    (the reference's runtime probe pattern, crt_filter.py:141-204).
    Memoized per (codec, binary): a segmented or batch render opens a
    writer per segment/clip, and hardware does not change mid-run."""
    exe = find_ffmpeg()
    if not exe:
        return False
    key = (codec, exe)
    if key not in _PROBE_CACHE:
        try:
            cmd = [
                exe, "-hide_banner", "-loglevel", "error",
                "-f", "lavfi", "-i", "color=c=black:s=16x16:d=0.05",
                "-c:v", codec, "-f", "null", "-",
            ]
            _PROBE_CACHE[key] = (
                subprocess.run(cmd, capture_output=True).returncode == 0)
        except Exception:
            _PROBE_CACHE[key] = False
    return _PROBE_CACHE[key]


def can_use_nvenc() -> bool:
    return _probe_encoder("h264_nvenc")


def can_use_amf() -> bool:
    return _probe_encoder("h264_amf")


def normalize_nvenc_preset(preset: str) -> str:
    """Map p1..p7 to legacy NVENC preset tokens; pass legacy names through;
    fall back to 'medium' (crt_filter.py:103-138)."""
    p = (preset or "").strip().lower()
    legacy = {
        "default", "slow", "medium", "fast", "hp", "hq", "bd",
        "ll", "llhq", "llhp", "lossless", "losslesshp",
    }
    if p in legacy:
        return p
    return {
        "p1": "hp", "p2": "fast", "p3": "medium", "p4": "default",
        "p5": "hq", "p6": "bd", "p7": "slow",
    }.get(p, "medium")


def map_decoder_to_hwaccel(pref: str) -> Optional[str]:
    """Decoder preference -> ffmpeg -hwaccel token (crt_filter.py:517-529)."""
    p = (pref or "auto").strip().lower()
    return {"nvidia": "cuda", "amd": "dxva2", "intel": "d3d11va"}.get(p)


def select_encoder(preference: str = "auto", gpu: bool = False) -> str:
    """Codec choice with probe-verified hardware fallback to libx264
    (crt_filter.py:938-953)."""
    pref = (preference or "auto").strip().lower()
    if pref == "nvidia":
        return "h264_nvenc" if can_use_nvenc() else "libx264"
    if pref == "amd":
        return "h264_amf" if can_use_amf() else "libx264"
    if pref == "cpu":
        return "libx264"
    if gpu and can_use_nvenc():
        return "h264_nvenc"
    if gpu and can_use_amf():
        return "h264_amf"
    return "libx264"


def encoder_ffparams(
    codec: str, crf: int, bitrate_kbps: int, nvenc_preset: str = "p4"
) -> list[str]:
    """Per-codec ffmpeg parameter block (crt_filter.py:956-1002)."""
    kbps = int(max(0, bitrate_kbps or 0))
    rate = ["-b:v", f"{kbps}k", "-maxrate", f"{kbps}k", "-bufsize", f"{kbps * 2}k"]
    if codec == "h264_nvenc":
        nv = normalize_nvenc_preset(nvenc_preset)
        if kbps > 0:
            return rate + ["-rc", "vbr", "-preset", nv, "-pix_fmt", "yuv420p"]
        return ["-cq", str(crf), "-preset", nv, "-pix_fmt", "yuv420p"]
    if codec == "h264_amf":
        return (rate if kbps > 0 else []) + ["-pix_fmt", "yuv420p"]
    if kbps > 0:
        return rate + ["-pix_fmt", "yuv420p"]
    return ["-crf", str(crf), "-pix_fmt", "yuv420p", "-preset", "medium"]


# --------------------------------------------------------------------------
# Probing clips
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class ClipInfo:
    width: int
    height: int
    fps: float
    frame_count: int

    @property
    def duration(self) -> float:
        return self.frame_count / self.fps if self.fps > 0 else 0.0


def _probe_clip_ffmpeg(exe: str, path: str | Path) -> ClipInfo:
    """Probe with the ffmpeg binary alone (no ffprobe): the input's
    stream header gives size and rate, and a stream-copy pass to the
    null muxer counts the frames without decoding them."""
    res = subprocess.run(
        [exe, "-hide_banner", "-nostdin", "-i", str(path), "-map", "0:v:0",
         "-c", "copy", "-f", "null", "-"],
        capture_output=True, text=True, errors="replace")
    err = res.stderr
    line = re.search(r"Stream #.*Video: .*", err)
    size = line and re.search(r"\b(\d{2,5})x(\d{2,5})\b", line.group(0))
    if res.returncode != 0 or not size:
        raise FileNotFoundError(f"cannot open video: {path}")
    rate = (re.search(r"([\d.]+) fps", line.group(0))
            or re.search(r"([\d.]+) tbr", line.group(0)))
    frames = re.findall(r"frame=\s*(\d+)", err)
    return ClipInfo(
        width=int(size.group(1)),
        height=int(size.group(2)),
        fps=float(rate.group(1)) if rate else 24.0,
        frame_count=int(frames[-1]) if frames else 0,
    )


def probe_clip(path: str | Path) -> ClipInfo:
    """Size, rate and frame count of a clip: OpenCV when it is
    installed, otherwise the ffmpeg binary."""
    try:
        import cv2
    except ImportError:
        exe = find_ffmpeg()
        if exe is None:
            raise RuntimeError(
                "probing a clip needs OpenCV or an ffmpeg binary") from None
        return _probe_clip_ffmpeg(exe, path)

    cap = cv2.VideoCapture(str(path))
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video: {path}")
    try:
        return ClipInfo(
            width=int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
            height=int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
            fps=float(cap.get(cv2.CAP_PROP_FPS) or 24.0),
            frame_count=int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
        )
    finally:
        cap.release()


# --------------------------------------------------------------------------
# Readers
# --------------------------------------------------------------------------

class FFmpegRawReader:
    """ffmpeg-subprocess decoder yielding (H, W, 3) RGB uint8 frames via a
    rawvideo stdout pipe, with optional -hwaccel and fps/scale conversion
    (reference FFmpegRawReader, crt_filter.py:469-514).

    pipe_format="yuv420p" halves the pipe bandwidth (1.5 vs 3 B/px) and
    converts on the host via the native BT.601 kernel — an opt-in perf
    mode (byte output differs slightly from ffmpeg's own rgb24 path).
    pipe_format="gbrp" yields PLANAR (3, H, W) uint8 frames in ffmpeg's
    G,B,R plane order — the engine's planar layout consumes these
    untouched (CRTEngine(layout="planar", channel_order="gbr")), so the
    decoded bytes reach the engine with zero host repack (the engine
    converts at the step edges). Same bytes per frame as rgb24; the caller's
    read_into buffer decides the shape (the read is format-blind).
    Reads use the native GIL-released exact-read loop when available.
    """

    def __init__(self, src: str, out_w: int, out_h: int, fps: float,
                 hwaccel: Optional[str] = None, pipe_format: str = "rgb24",
                 start_frame: int = 0,
                 src_fps: Optional[float] = None) -> None:
        # src_fps: pass the already-probed source rate to skip the
        # per-construction probe_clip (ChunkedParallelReader opens one
        # reader per chunk on the hot decode path)
        exe = find_ffmpeg()
        if not exe:
            raise RuntimeError("no ffmpeg binary available")
        if pipe_format not in ("rgb24", "yuv420p", "gbrp"):
            raise ValueError(f"unsupported pipe_format {pipe_format!r}")
        self.out_w, self.out_h = int(out_w), int(out_h)
        self.pipe_format = pipe_format
        self.frame_shape = ((3, self.out_h, self.out_w)
                            if pipe_format == "gbrp"
                            else (self.out_h, self.out_w, 3))
        self._yuv_buf = None
        cmd = [exe, "-hide_banner", "-loglevel", "error"]
        if hwaccel and hwaccel != "auto":
            cmd += ["-hwaccel", hwaccel]
        self._skip = 0
        if start_frame > 0:
            # accurate input seek: keyframe seek + decode-and-discard up
            # to the exact target, so resume cost is O(remaining) instead
            # of a full-prefix decode (segment resume, segments.py).
            # ONLY when the output rate matches the source rate: with -r
            # resampling, an input-side -ss rebases the CFR grid on the
            # first decoded pts, which can select source frames off by
            # one near the seek vs an uninterrupted render — those
            # clips decode-and-discard instead (correct, O(prefix)).
            if src_fps is None:
                try:
                    src_fps = probe_clip(src).fps
                except Exception:
                    src_fps = 0.0
            if abs(src_fps - float(fps)) < 1e-3:
                # target HALF A FRAME EARLY: f"{k/fps:.6f}" rounds to the
                # nearest microsecond, and rounding UP past frame k's true
                # pts would make ffmpeg's accurate seek drop frame k (a
                # one-frame shift that breaks segments.py's bit-identical
                # resume). Midway between the pts of frames k-1 and k is
                # unambiguous under the keep-frames-with-pts>=target rule.
                ts = max(0.0, (start_frame - 0.5) / float(fps))
                cmd += ["-ss", f"{ts:.6f}"]
            else:
                self._skip = int(start_frame)
        cmd += [
            "-i", str(src),
            "-vf", f"scale={self.out_w}:{self.out_h}",
            "-r", str(fps),
            "-f", "rawvideo", "-pix_fmt", pipe_format, "-",
        ]
        self.proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.DEVNULL)
        self._primed: Optional[np.ndarray] = None

    def _prime(self) -> bool:
        """Decode one frame ahead (open_reader's hwaccel runtime probe —
        a bad -hwaccel only fails at the first read, not at Popen);
        the frame is handed to the first read_into call."""
        buf = np.empty(self.frame_shape, np.uint8)
        ok = self.read_into(buf)
        if ok:
            self._primed = buf
        return ok

    def read_into(self, out: np.ndarray) -> bool:
        """Decode the next frame directly into ``out`` ((H, W, 3) uint8,
        C-contiguous) — zero staging copies on the rgb24 path (the pipe
        read lands in the caller's batch buffer). Returns False at EOF."""
        if self._primed is not None:
            out[...] = self._primed
            self._primed = None
            return True
        if self._skip > 0:
            junk = np.empty((self.out_h, self.out_w, 3), np.uint8)
            while self._skip > 0:
                self._skip -= 1
                if not self._read_one(junk):
                    return False
        return self._read_one(out)

    def _read_one(self, out: np.ndarray) -> bool:
        from .. import native

        w, h = self.out_w, self.out_h
        assert self.proc.stdout is not None
        if self.pipe_format == "yuv420p":
            nbytes = w * h * 3 // 2
            if self._yuv_buf is None or len(self._yuv_buf) != nbytes:
                self._yuv_buf = bytearray(nbytes)
            got = native.readinto_exact(self.proc.stdout, memoryview(self._yuv_buf))
            if got < nbytes:
                return self._eof_or_raise()
            out[...] = native.yuv420p_to_rgb24(bytes(self._yuv_buf), w, h)
            return True
        view = memoryview(out).cast("B")
        got = native.readinto_exact(self.proc.stdout, view)
        if got == w * h * 3:
            return True
        return self._eof_or_raise()

    def _eof_or_raise(self) -> bool:
        """A short read is a clean EOF only if the decoder exited 0.
        A nonzero exit (unsupported -hwaccel, corrupt input, mid-stream
        crash) raises instead of being swallowed as EOF — otherwise a
        failed decode produces a truncated or empty render reported as
        success (the encoder-side close() already has this check)."""
        try:
            rc = self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            raise RuntimeError(
                "ffmpeg decoder closed its output pipe but did not exit")
        if rc != 0:
            raise RuntimeError(f"ffmpeg decoder exited with code {rc}")
        return False

    def iter_frames(self) -> Iterator[np.ndarray]:
        while True:
            out = np.empty(self.frame_shape, np.uint8)
            if not self.read_into(out):
                return
            yield out

    def close(self) -> None:
        """Stop AND reap the decoder child: terminate() alone leaves a
        zombie per reader, and ChunkedParallelReader opens one reader per
        chunk, so long batch renders would accumulate defunct ffmpegs."""
        try:
            if self.proc.stdout:
                self.proc.stdout.close()
        except Exception:
            pass
        try:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=5)
        except Exception:
            pass


class CV2Reader:
    """OpenCV decoder with nearest-timestamp fps resampling and on-read
    resize; yields (H, W, 3) RGB uint8 frames."""

    def __init__(self, src: str, out_w: int, out_h: int, fps: float,
                 start_frame: int = 0) -> None:
        import cv2

        self._cv2 = cv2
        self.cap = cv2.VideoCapture(str(src))
        if not self.cap.isOpened():
            raise FileNotFoundError(f"cannot open video: {src}")
        self.out_w, self.out_h = int(out_w), int(out_h)
        self.src_fps = float(self.cap.get(cv2.CAP_PROP_FPS) or fps)
        self.out_fps = float(fps)
        self.start_frame = int(start_frame)
        self._src_i = -1
        self._out_i = self.start_frame
        self._frame = None
        ratio = self.src_fps / self.out_fps
        if self._out_i > 0:
            # positioned read: jump to the source frame feeding output
            # frame start_frame (O(remaining) resume). CAP_PROP_POS_FRAMES
            # is not trusted blindly: verify where the backend actually
            # landed; short landings self-correct (the read loop decodes
            # forward to the exact target), and a landing PAST the target
            # or an unreadable position reopens and decodes from 0
            # (slow but exact).
            want0 = int(round(self._out_i * ratio))
            if want0 > 0 and self.cap.set(cv2.CAP_PROP_POS_FRAMES, want0):
                pos = int(self.cap.get(cv2.CAP_PROP_POS_FRAMES))
                if 0 <= pos <= want0:
                    self._src_i = pos - 1
                else:
                    self.cap.release()
                    self.cap = cv2.VideoCapture(str(src))
                    if not self.cap.isOpened():
                        # a failed reopen must raise, not let read() report
                        # EOF and pass a truncated render off as success
                        raise FileNotFoundError(f"cannot open video: {src}")
                    self._src_i = -1

    def read_into(self, out: np.ndarray) -> bool:
        """Decode the next output frame into ``out`` ((H, W, 3) uint8);
        the BGR->RGB convert (and resize, if any) write straight into the
        caller's batch buffer. Returns False at EOF."""
        cv2 = self._cv2
        want = int(round(self._out_i * (self.src_fps / self.out_fps)))
        while self._src_i < want:
            ok, bgr = self.cap.read()
            if not ok:
                return False
            self._src_i += 1
            self._frame = bgr
        f = self._frame
        if f.shape[1] != self.out_w or f.shape[0] != self.out_h:
            f = cv2.resize(f, (self.out_w, self.out_h),
                           interpolation=cv2.INTER_LINEAR)
        cv2.cvtColor(f, cv2.COLOR_BGR2RGB, dst=out)
        self._out_i += 1
        return True

    def iter_frames(self) -> Iterator[np.ndarray]:
        while True:
            out = np.empty((self.out_h, self.out_w, 3), np.uint8)
            if not self.read_into(out):
                return
            yield out

    def close(self) -> None:
        self.cap.release()


class ChunkedParallelReader:
    """N seek-positioned decode workers, frame-range partitioned into
    interleaved chunks, emitting in-order zero-copy batches.

    1080p at 1000 fps needs ~6 GB/s of RGB out of the decoder — more
    than one ffmpeg/cv2 stream delivers (SURVEY.md §7 hard part 3), so
    worker w decodes chunks w, w+N, w+2N, ... (chunk = chunk_batches
    batches), each via an accurate seek open, and iter_batches() yields
    (abs_index, (B, H, W, 3) uint8) strictly in order. Frames are
    decoded straight into the batch buffers (read_into), so the only
    copy on the host is the decoder's own pipe/convert write.
    """

    def __init__(self, src: str, out_w: int, out_h: int, fps: float,
                 total_frames: int, batch_size: int, *,
                 workers: int = 2, chunk_batches: int = 4,
                 decoder_preference: str = "auto", pipe_format: str = "rgb24",
                 start_frame: int = 0) -> None:
        import queue as _q
        import threading as _t

        self.src, self.out_w, self.out_h, self.fps = str(src), int(out_w), int(out_h), float(fps)
        self.pref, self.pipe_format = decoder_preference, pipe_format
        self.frame_shape = ((3, self.out_h, self.out_w)
                            if pipe_format == "gbrp"
                            else (self.out_h, self.out_w, 3))
        self.batch = int(batch_size)
        # cap resident chunk buffers: each worker holds up to 3 chunks
        # (queue 2 + in-flight), so at 4K a 64-frame chunk would pin
        # gigabytes — shrink chunk_batches until a chunk stays <= 256 MB
        frame_bytes = self.out_h * self.out_w * 3
        cb = max(1, int(chunk_batches))
        while cb > 1 and cb * self.batch * frame_bytes > 256 << 20:
            cb -= 1
        self.chunk = self.batch * cb
        self.start = int(start_frame)
        # total_frames is an estimate; a resume may journal MORE frames
        # than a re-probe estimates (the last chunk deliberately reads
        # past the estimate). start > total must be a clean 0-frame EOF
        # like the sequential reader, not a negative buffer dimension.
        self.total = max(int(total_frames), self.start)
        n_chunks = max(1, -(-(self.total - self.start) // self.chunk))
        self.n_chunks = n_chunks
        # fps resampling forbids the per-chunk seek-positioned open (an
        # input-side -ss rebases the -r CFR grid, and the skip-decode
        # fallback would decode every chunk's full prefix = O(chunks^2)
        # total work) — degrade to ONE sequential reader shared across
        # all chunks: same in-order output, O(stream) decode.
        try:
            src_fps = probe_clip(src).fps
        except Exception:
            src_fps = float(fps)
        self._src_fps = float(src_fps)  # reused by every per-chunk open
        self._sequential = abs(src_fps - float(fps)) > 1e-3
        self.workers = 1 if self._sequential else max(1, min(int(workers), n_chunks))
        self._qs = [_q.Queue(maxsize=2) for _ in range(self.workers)]
        self._err = None
        self._stop = _t.Event()
        self._threads = [
            _t.Thread(target=self._worker, args=(w,), daemon=True)
            for w in range(self.workers)
        ]
        for t in self._threads:
            t.start()

    def _put(self, q, item) -> bool:
        """Blocking put that bails out when the consumer stopped; True if
        the item was enqueued."""
        import queue as _q

        while not self._stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except _q.Full:
                continue
        return False

    def _worker(self, wid: int) -> None:
        q = self._qs[wid]
        seq_rdr = None
        try:
            if self._sequential:
                seq_rdr = open_reader(self.src, self.out_w, self.out_h,
                                      self.fps, self.pref, self.pipe_format,
                                      start_frame=self.start)
            for ci in range(wid, self.n_chunks, self.workers):
                if self._stop.is_set():
                    break
                f0 = self.start + ci * self.chunk
                f1 = min(self.start + (ci + 1) * self.chunk, self.total)
                rdr = seq_rdr if seq_rdr is not None else open_reader(
                    self.src, self.out_w, self.out_h, self.fps,
                    self.pref, self.pipe_format, start_frame=f0,
                    src_fps=self._src_fps)
                try:
                    got = 0
                    buf = np.empty((f1 - f0, *self.frame_shape), np.uint8)
                    while got < f1 - f0 and not self._stop.is_set():
                        if not rdr.read_into(buf[got]):
                            break
                        got += 1
                    if not self._put(q, (ci, f0, buf[:got])):
                        break
                    if got < f1 - f0:
                        break  # EOF short of expectation: downstream stops here
                    if ci == self.n_chunks - 1:
                        # total_frames is an estimate (ceil(duration*fps));
                        # the LAST chunk reads on to true EOF so an
                        # underestimated duration can't silently truncate
                        # the render. Extras stream out in chunk-sized
                        # continuation items, so a badly wrong estimate
                        # can't pin unbounded RAM in one queue item.
                        ext = self.n_chunks
                        while not self._stop.is_set():
                            ebuf = np.empty((self.chunk, *self.frame_shape), np.uint8)
                            egot = 0
                            while (egot < self.chunk and not self._stop.is_set()
                                   and rdr.read_into(ebuf[egot])):
                                egot += 1
                            ef0 = self.total + (ext - self.n_chunks) * self.chunk
                            if egot and not self._put(q, (ext, ef0, ebuf[:egot])):
                                break
                            if egot < self.chunk:
                                break
                            ext += 1
                finally:
                    if rdr is not seq_rdr:
                        rdr.close()
        except Exception as e:
            # a decode failure must surface, not masquerade as EOF:
            # iter_batches re-raises it at this worker's next chunk
            self._err = e
        finally:
            if seq_rdr is not None:
                try:
                    seq_rdr.close()
                except Exception:
                    pass
            # never droppable: iter_batches blocks on this queue until a
            # sentinel arrives; bail out only when the consumer stopped
            self._put(q, None)

    def iter_batches(self, batch_size: int):
        """Yield (abs_frame_index, (<=batch_size, H, W, 3) uint8 view)
        strictly in stream order."""
        assert batch_size == self.batch
        ci = 0
        while True:
            # continuation items (>= n_chunks: last-chunk EOF extension)
            # always come from the worker that owned the last chunk
            qi = (ci if ci < self.n_chunks else self.n_chunks - 1) % self.workers
            item = self._qs[qi].get()
            if item is None:
                if self._err is not None:
                    raise RuntimeError("parallel decode worker failed") from self._err
                return
            got_ci, f0, frames = item
            assert got_ci == ci, (got_ci, ci)
            for b0 in range(0, frames.shape[0], self.batch):
                yield f0 + b0, frames[b0:b0 + self.batch]
            expect = self.chunk if ci >= self.n_chunks else min(self.chunk, self.total - f0)
            if frames.shape[0] < expect:
                return  # early EOF (or the final partial continuation)
            ci += 1

    def iter_frames(self):  # compatibility with the sequential interface
        for _, batch in self.iter_batches(self.batch):
            yield from batch

    def close(self) -> None:
        self._stop.set()
        for q in self._qs:
            try:
                while True:
                    q.get_nowait()
            except Exception:
                pass
        for t in self._threads:
            t.join(timeout=10)


def open_reader(
    src: str, out_w: int, out_h: int, fps: float, decoder_preference: str = "auto",
    pipe_format: str = "rgb24", start_frame: int = 0,
    src_fps: "Optional[float]" = None,
):
    """Tier-by-tier reader selection: hwaccel ffmpeg -> plain ffmpeg ->
    OpenCV (the reference's fallback-chain pattern, crt_filter.py:1024-1036).

    start_frame: first output frame to yield (decoder-side seek)."""
    accel = map_decoder_to_hwaccel(decoder_preference)
    if find_ffmpeg():
        try:
            rd = FFmpegRawReader(src, out_w, out_h, fps, accel, pipe_format,
                                 start_frame, src_fps=src_fps)
            if accel:
                # runtime tier probe: an unsupported -hwaccel exits
                # nonzero only once decoding starts, so prime one frame
                # and fall to the plain-ffmpeg tier on failure (the
                # reference's probe-and-fallback, crt_filter.py:1024-1036)
                try:
                    rd._prime()
                except RuntimeError:
                    rd.close()
                    rd = FFmpegRawReader(src, out_w, out_h, fps, None,
                                         pipe_format, start_frame,
                                         src_fps=src_fps)
            return rd
        except Exception:
            if pipe_format == "gbrp":
                raise  # planar frames need the ffmpeg pipe; no cv2 shape
    elif pipe_format == "gbrp":
        raise RuntimeError("pipe_format 'gbrp' requires an ffmpeg binary")
    return CV2Reader(src, out_w, out_h, fps, start_frame)


# --------------------------------------------------------------------------
# Writers
# --------------------------------------------------------------------------

class FFmpegRawWriter:
    """ffmpeg-subprocess encoder consuming uint8 frames over a rawvideo
    stdin pipe (the FFMPEG_VideoWriter role, crt_filter.py:1014).

    pix_fmt="rgb24" takes interleaved (H, W, 3) frames; "gbrp" takes
    PLANAR (3, H, W) frames in G,B,R plane order — the engine's planar
    layout emits exactly those bytes, so device output pipes into the
    encoder with zero host repack (ffmpeg's swscale converts either
    format to the encoder's yuv target the same way)."""

    def __init__(self, dst: str, w: int, h: int, fps: float, codec: str,
                 ffparams: list[str], audio_path: Optional[str] = None,
                 pix_fmt: str = "rgb24") -> None:
        exe = find_ffmpeg()
        if not exe:
            raise RuntimeError("no ffmpeg binary available")
        if pix_fmt not in ("rgb24", "gbrp"):
            raise ValueError(f"unsupported pix_fmt {pix_fmt!r}")
        cmd = [
            exe, "-hide_banner", "-loglevel", "error", "-y",
            "-f", "rawvideo", "-pix_fmt", pix_fmt, "-s", f"{w}x{h}",
            "-r", str(fps), "-i", "-",
        ]
        if audio_path:
            cmd += ["-i", audio_path, "-c:a", "aac", "-shortest"]
        cmd += ["-c:v", codec] + list(ffparams) + [str(dst)]
        self.proc = subprocess.Popen(cmd, stdin=subprocess.PIPE,
                                     stderr=subprocess.DEVNULL)

    def write_frame(self, rgb_u8: np.ndarray) -> None:
        assert self.proc.stdin is not None
        # write the buffer directly (no tobytes() copy): a C-contiguous
        # ndarray's memoryview feeds the pipe at ~6 GB/s target rates
        a = rgb_u8 if rgb_u8.flags["C_CONTIGUOUS"] else np.ascontiguousarray(rgb_u8)
        self.proc.stdin.write(a.data)

    def close(self) -> None:
        """Flush and reap the encoder; a nonzero ffmpeg exit (or a hang)
        raises so a truncated/failed encode is never reported as success
        (the reference's moviepy writer surfaces encode errors too)."""
        try:
            if self.proc.stdin:
                self.proc.stdin.close()
        except BrokenPipeError:
            pass  # child already dead; its exit code tells the story
        try:
            rc = self.proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            raise RuntimeError("ffmpeg encoder did not exit within 60s")
        if rc != 0:
            raise RuntimeError(f"ffmpeg encoder exited with code {rc}")


class CV2Writer:
    """OpenCV encoder fallback (mp4v/avc1), RGB in, video-only."""

    def __init__(self, dst: str, w: int, h: int, fps: float) -> None:
        import cv2

        self._cv2 = cv2
        self.writer = None
        # silence codec-probe noise (failed fourccs log ERROR lines)
        prev_level = None
        try:
            prev_level = cv2.utils.logging.getLogLevel()
            cv2.utils.logging.setLogLevel(cv2.utils.logging.LOG_LEVEL_SILENT)
        except Exception:
            pass
        try:
            for fourcc in ("avc1", "mp4v", "MJPG"):
                wtr = cv2.VideoWriter(str(dst), cv2.VideoWriter_fourcc(*fourcc),
                                      float(fps), (int(w), int(h)))
                if wtr.isOpened():
                    self.writer = wtr
                    break
        finally:
            if prev_level is not None:
                try:
                    cv2.utils.logging.setLogLevel(prev_level)
                except Exception:
                    pass
        if self.writer is None:
            raise RuntimeError(f"cv2.VideoWriter could not open {dst}")

    def write_frame(self, rgb_u8: np.ndarray) -> None:
        self.writer.write(self._cv2.cvtColor(rgb_u8, self._cv2.COLOR_RGB2BGR))

    def close(self) -> None:
        self.writer.release()


def open_writer(
    dst: str, w: int, h: int, fps: float, *,
    encoder_preference: str = "auto", gpu: bool = False, crf: int = 18,
    bitrate_kbps: int = 0, nvenc_preset: str = "p4",
    audio_path: Optional[str] = None, pix_fmt: str = "rgb24",
) -> tuple[object, bool]:
    """Returns (writer, used_gpu). pix_fmt="gbrp" (planar frames)
    requires the ffmpeg pipe — there is no cv2 fallback for it."""
    if find_ffmpeg():
        codec = select_encoder(encoder_preference, gpu)
        params = encoder_ffparams(codec, crf, bitrate_kbps, nvenc_preset)
        try:
            return (
                FFmpegRawWriter(dst, w, h, fps, codec, params, audio_path,
                                pix_fmt=pix_fmt),
                codec in ("h264_nvenc", "h264_amf"),
            )
        except Exception:
            if pix_fmt != "rgb24":
                raise
    elif pix_fmt != "rgb24":
        raise RuntimeError(f"pix_fmt {pix_fmt!r} requires an ffmpeg binary")
    return CV2Writer(dst, w, h, fps), False


# --------------------------------------------------------------------------
# Audio passthrough (ffmpeg-only; degrades to mute like the reference)
# --------------------------------------------------------------------------

def extract_audio(src: str | Path, tmp_dir: Optional[str] = None) -> Optional[str]:
    """Extract the audio track to a temp AAC file (crt_filter.py:926-935);
    returns None (mute output) if no ffmpeg or no/failed audio."""
    exe = find_ffmpeg()
    if not exe:
        return None
    import tempfile

    fd, path = tempfile.mkstemp(suffix=".aac", dir=tmp_dir)
    os.close(fd)
    try:
        with perf.timed("io.audio_extract"):
            res = subprocess.run(
                [exe, "-hide_banner", "-loglevel", "error", "-y", "-i", str(src),
                 "-vn", "-c:a", "aac", "-b:a", "128k", "-ar", "44100", path],
                capture_output=True,
            )
        if res.returncode == 0 and os.path.getsize(path) > 0:
            return path
    except Exception:
        pass
    try:
        os.unlink(path)
    except OSError:
        pass
    return None
