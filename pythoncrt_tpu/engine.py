"""CRT effect engine: the whole effect chain as one compiled JAX program.

One engine, not two: the reference splits preview/export into two
near-duplicate Python functions (crt_filter.py:531 vs :702) because of
host threading; here a single pure batched transform

    step : (frames_u8 [B,H,W,3], aux, state [H,W,3]) -> (out_u8, state)

serves both, compiled once per parameter set. Design (SURVEY.md §7):

- All ~35 effect parameters are *static*: identity stages vanish at
  trace time, constants fold, and XLA fuses the surviving stages into
  a few device kernels over the NHWC batch.
- Masks, LUT grids, warp tables, resize taps and text overlays are
  precomputed on the host by the oracle (single source of truth for
  bit-accuracy) and uploaded once as device constants.
- Per-frame temporal inputs (scanline phase, flicker gain) are computed
  host-side in f64 (matching the reference's NumPy scalar math) and
  shipped as (B,) f32 arrays.
- Noise / glitch randomness: "native" mode draws on device from
  counter-based keys (fold_in(seed, frame_index) — deterministic,
  reproducible, jit-contained); "host" mode injects reference-exact
  fields for parity testing.
- The persistence IIR s_t = p*s_{t-1} + (1-p)*x_t (crt_filter.py:1092)
  runs as a lax.scan over the batch axis after the vmapped stateless
  chain, carrying one frame across batch (and shard) boundaries.
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

# Fixed compile-cache directory inside the checkout: the path is part of
# the cache key, so it never depends on a tempdir, a pid or a time.
COMPILE_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def _enable_compile_cache() -> None:
    """Persistent XLA compilation cache on the GPU, so every (params,
    shape) program compiles once across processes.

    JAX_COMPILATION_CACHE_DIR, when set, is JAX's own setting and is
    left to JAX; otherwise the cache lives in COMPILE_CACHE_DIR. Off on
    the CPU backend: cached CPU AOT results depend on the host
    machine's features."""
    if jax.default_backend() != "gpu" or os.environ.get(
            "JAX_COMPILATION_CACHE_DIR"):
        return
    jax.config.update("jax_compilation_cache_dir", COMPILE_CACHE_DIR)


from . import oracle
from .oracle import ops as oops
from .ops import blur as oblur
from .ops import color as ocolor
from .ops import glitch as oglitch
from .ops import resize as oresize
from .ops import warp as owarp
from .params import EffectParams


def _draw_normal(key, gh: int, gw: int, dt) -> jax.Array:
    """Per-frame (gh, gw) standard-normal grain field for rng="native".

    Default: jax.random.normal (erfinv transform).

    PCRT_NORMAL_IMPL=bm: paired Box-Muller — one (gh, gw/2) uniform
    pair makes TWO normals (z1 = r*cos(2*pi*u2), z2 = r*sin(2*pi*u2),
    r = sqrt(-2*ln(u1))), halving the transcendental work per element;
    the halves land side-by-side (iid, so any fixed arrangement is a
    valid field). Exact N(0,1) by construction — distribution-legal for
    rng="native" (PARITY.md: the native stream never promises the
    reference's numpy draws, only the distribution; parity tests feed
    the SAME field to engine and oracle). Keyed per frame (fold_in
    upstream), elementwise after the draw, so batch-shape/resume
    invariance is automatic (test_native_rng_resume_invariant covers
    both impls). An A/B knob; its speed on the GPU is not measured.
    """
    if os.environ.get("PCRT_NORMAL_IMPL") == "bm":
        k1, k2 = jax.random.split(key)
        hw = (gw + 1) // 2
        tiny = np.float32(np.finfo(np.float32).tiny)
        u1 = jax.random.uniform(k1, (gh, hw), jnp.float32, minval=tiny)
        u2 = jax.random.uniform(k2, (gh, hw), jnp.float32)
        r = jnp.sqrt(np.float32(-2.0) * jnp.log(u1))
        th = np.float32(2.0 * np.pi) * u2
        field = jnp.concatenate([r * jnp.cos(th), r * jnp.sin(th)], axis=1)
        field = field[:, :gw]
        return field.astype(dt).astype(jnp.float32)
    return jax.random.normal(key, (gh, gw), dt).astype(jnp.float32)


class FrameAux(NamedTuple):
    """Per-frame dynamic inputs (each leaf has a leading batch axis)."""

    frame_idx: jax.Array  # (B,) int32
    phase: jax.Array  # (B,) f32 scanline phase in px
    flicker: jax.Array  # (B,) f32 flicker gain (1.0 when flicker off)
    noise: Optional[jax.Array] = None  # (B, gh, gw) f32 std-normal (host mode)
    glitch_base: Optional[jax.Array] = None  # (B, rows) f32 (host mode)
    glitch_seg: Optional[jax.Array] = None  # (B, rows, segs) f32 (host mode)


class CRTEngine:
    """Compiled effect pipeline for one (params, H, W, fps) configuration.

    Args:
      params: effect parameters (clamped; static — changing them builds a
        new engine / triggers recompilation, like loading a new preset).
      height, width: frame size.
      fps: output frame rate (drives phase/time per frame index).
      engine: "export" (canonical algorithm set, crt_filter.py:702-861)
        or "preview" (the preview glitch variant, :664-686).
      rng: "native" (on-device counter-based draws) or "host"
        (reference-exact fields injected through FrameAux).
      seed: base RNG seed for native mode.
      text_rgba: optional (H, W, 4) uint8 overlay (host-rasterized once;
        see pythoncrt_tpu.text).
      lut_exact: replicate the triad 1024-bin LUT quantization.
      precision: "exact" (default; <=1 LSB vs the CPU oracle, LUT-exact
        triad) or "fast" (the triad's direct pow without the LUT
        quantize; up to a few uint8 LSB vs the oracle near black — a
        documented deviation).
      assoc_scan: use an O(log B) associative scan for the persistence
        recurrence (same math, f32 reassociation differences only).
      layout: "nhwc" (default) — process() takes/returns (B, H, W, 3)
        uint8 and the state is (H, W, 3). "planar" — (B, 3, H, W) /
        (3, H, W); the step converts to NHWC at its edges (values are
        bit-identical across layouts: transposes carry no arithmetic).
        "auto" resolves to "nhwc" — read self.layout after construction
        to learn the I/O contract.
      channel_order: which color each PLANE of a planar frame holds —
        "rgb" (default) or "gbr" (ffmpeg's gbrp plane order, so decoded
        planes and encoder input need no host repack). Output planes
        come back in the same order. Only meaningful with layout
        "planar"/"auto".
    """

    def __init__(
        self,
        params: EffectParams,
        height: int,
        width: int,
        fps: float,
        *,
        engine: str = "export",
        rng: str = "native",
        seed: int = 0,
        text_rgba: Optional[np.ndarray] = None,
        lut_exact: bool = True,
        precision: str = "exact",
        assoc_scan: bool = False,
        layout: str = "nhwc",
        channel_order: str = "rgb",
    ) -> None:
        if engine not in ("export", "preview"):
            raise ValueError(f"engine must be 'export' or 'preview', got {engine!r}")
        if rng not in ("native", "host"):
            raise ValueError(f"rng must be 'native' or 'host', got {rng!r}")
        if precision not in ("exact", "fast"):
            raise ValueError(f"precision must be 'exact' or 'fast', got {precision!r}")
        if layout not in ("nhwc", "planar", "auto"):
            raise ValueError(
                f"layout must be 'nhwc', 'planar' or 'auto', got {layout!r}")
        if channel_order not in ("rgb", "gbr"):
            raise ValueError(
                f"channel_order must be 'rgb' or 'gbr', got {channel_order!r}")
        if channel_order != "rgb" and layout == "nhwc":
            raise ValueError("channel_order requires layout 'planar'/'auto'")
        _enable_compile_cache()
        p = params.clamped()
        self.params = p
        self.h, self.w = int(height), int(width)
        self.fps = float(fps)
        self.engine = engine
        self.rng = rng
        self.seed = int(seed)
        self.precision = precision
        self.lut_exact = bool(lut_exact) and precision == "exact"
        self.assoc_scan = bool(assoc_scan)
        self.layout = "nhwc" if layout == "auto" else layout
        self.channel_order = channel_order
        # plane i of a planar frame holds color _plane_colors[i]
        # (0=R, 1=G, 2=B); gbr is ffmpeg's gbrp plane order
        self._plane_colors = (0, 1, 2) if channel_order == "rgb" else (1, 2, 0)
        self._build_consts(text_rgba)
        # Constants (masks, warp tables, index maps) are passed as jit
        # ARGUMENTS, not closure captures: captured arrays embed as HLO
        # literals, which blows up compile time at 1080p+ (tens of MB of
        # warp/triad tables). As parameters they stay resident on the
        # device across calls and the program compiles quickly.
        self._jstep = jax.jit(self._step)
        self._jmstep = jax.jit(self._multi_step)

    # ------------------------------------------------------------------
    # Host-side constant tables (oracle is the single source of truth)
    # ------------------------------------------------------------------

    def _build_consts(self, text_rgba: Optional[np.ndarray]) -> None:
        p, h, w = self.params, self.h, self.w
        # Grain half-row decomposition: upsample columns with a bf16 dot
        # at gh rows and rows with a second bf16 row-matrix dot
        # (_grain_rows_full). Envelope: grain_size 2 (bf16-exact
        # 0.25/0.75 taps) and the field's bf16 truncation (~2^-9) under
        # the noise_strength/255 scale stays far below 1 LSB.
        # PCRT_GRAIN_LERP=0 restores the two-dot f32 form for A/B.
        g_sz = max(1, int(p.grain_size))
        self._grain_lerp = (
            p.noise_on and g_sz == 2 and h % 2 == 0 and h // 2 >= 2
            and float(p.noise_strength) <= 32.0
            and os.environ.get("PCRT_GRAIN_GATHER") != "1"
            and os.environ.get("PCRT_GRAIN_ROLL") != "1"
            and os.environ.get("PCRT_GRAIN_LERP") != "0")
        c: dict = {}

        if p.pixelate_on:
            y_map, x_map = oracle.pixelate_index_maps(h, w, p.pixel_size)
            c["pix_y"] = jnp.asarray(y_map)
            # Aberration (stage 2, wrap-around x roll per channel) and
            # pixelate (stage 3, static nearest gather) are both static
            # index maps on x, so they COMPOSE: one per-channel map runs
            # on the uint8 input and the aberration rolls vanish.
            ab = int(p.aberration_px) if p.aberration_on else 0
            xm = {0: (x_map - ab) % w, 1: x_map, 2: (x_map + ab) % w}
            self._pix_chan_maps = ab != 0
            if self._pix_chan_maps:
                c["pix_x"], c["pix_x_r"], c["pix_x_b"] = (
                    jnp.asarray(xm[1]), jnp.asarray(xm[0]), jnp.asarray(xm[2])
                )
            else:
                c["pix_x"] = jnp.asarray(x_map)
            # shift-selected rolls fuse into the elementwise chain where
            # a gather would split it (static per config)
            self._pix_shifts = (
                oresize.roll_gather_shifts(y_map),
                tuple(oresize.roll_gather_shifts(xm[i]) for i in range(3)),
            )

        if p.bloom_on:
            if p.fast_bloom:
                h2, w2 = max(1, h // 2), max(1, w // 2)
                c["bloom_down"] = tuple(jnp.asarray(a) for a in
                                        (*oops.bilinear_taps(h, h2), *oops.bilinear_taps(w, w2)))
                c["bloom_up"] = tuple(jnp.asarray(a) for a in
                                      (*oops.bilinear_taps(h2, h), *oops.bilinear_taps(w2, w)))
            else:
                k = max(1, int(round(p.bloom_sigma * 3)) * 2 + 1)
                taps = tuple(float(t) for t in oops.gaussian_kernel_1d(k, p.bloom_sigma))
                self._bloom_taps = taps

        if p.triad_on:
            # The aperture-grille mask is y-invariant (the soften blur is
            # x-only), so ONE (W, 3) row broadcasts instead of an
            # (H, W, 3) constant re-read once per frame. Same bytes.
            c["triad"] = jnp.asarray(
                oracle.triad_mask(1, w, p.triad_strength, p.triad_softness)[0]
            )

        if p.scanlines_on:
            self._sl_omega = np.float32(2.0 * np.pi / max(1e-6, p.scanline_period_px))
            if p.scanlines_1d:
                c["sl_y"] = jnp.asarray(np.arange(h, dtype=np.float32))
            else:
                c["sl_slant"] = jnp.asarray(oracle.scanline_slant(h, w, p.scanline_angle))
                self._sl_inv_sharp = np.float32(
                    1.0 / float(np.clip(p.scanline_thickness, 0.1, 4.0))
                )

        if p.vignette_on:
            # Separable form: r2 = ny2[:, None] + nx2[None, :] built
            # inside the fusion from two vectors instead of an (H, W)
            # mask constant. The f32 vector add rounds once where the
            # oracle rounds its f64 sum once: <= 1 ulp on the mask
            # value, far below the uint8 budget (suite-asserted).
            yy = np.arange(h, dtype=np.float64)
            xx = np.arange(w, dtype=np.float64)
            cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
            rx, ry = max(1.0, w / 2.0), max(1.0, h / 2.0)
            ny = (yy - cy) / ry
            nx = (xx - cx) / rx
            c["vig_ny2"] = jnp.asarray((ny * ny).astype(np.float32))
            c["vig_nx2"] = jnp.asarray((nx * nx).astype(np.float32))
            self._vig_strength = np.float32(p.vignette_strength)

        if p.noise_on:
            g = max(1, int(p.grain_size))
            self._grain_hw = (max(1, h // g), max(1, w // g)) if g > 1 else (h, w)
            self._grain_mx = False
            self._grain_roll = False
            if g > 1:
                gh, gw = self._grain_hw
                # Exact-2x upsample as repeat + static rolls
                # (ops/resize.py:resize2x_roll): f32 lerps in the
                # oracle's tap order, BITWISE equal to the numpy oracle.
                # Opt-in (PCRT_GRAIN_ROLL=1): XLA materializes the
                # roll/select chain as several full-res passes.
                roll_ok = (g == 2 and h == 2 * gh and w == 2 * gw
                           and os.environ.get("PCRT_GRAIN_ROLL") == "1")
                if roll_ok:
                    self._grain_roll = True
                    ylo, yf = oops.bilinear_taps(gh, h)
                    xlo, xf = oops.bilinear_taps(gw, w)
                    c["grain_wy"] = (jnp.asarray((1.0 - yf).reshape(h, 1)),
                                     jnp.asarray(yf.reshape(h, 1)))
                    c["grain_wx"] = (jnp.asarray((1.0 - xf).reshape(1, w)),
                                     jnp.asarray(xf.reshape(1, w)))
                # The matmul forms are contract-safe only where the bf16
                # field truncation of the lerp form stays under the
                # 1-LSB budget: err_u8 ~ 2^-9 * |field| * noise_strength
                # <= 5*strength/512, and the tap weights must be
                # bf16-exact (grain_size 2: 0.25/0.75). Outside that
                # envelope, keep the gathers.
                mx_ok = (g == 2 and p.noise_strength <= 32.0
                         and os.environ.get("PCRT_GRAIN_GATHER") != "1")
                if roll_ok:
                    pass
                elif not mx_ok:
                    c["grain_taps"] = tuple(jnp.asarray(a) for a in
                                            (*oops.bilinear_taps(gh, h), *oops.bilinear_taps(gw, w)))
                else:
                    # The 2-tap bilinear upsample as two small dense
                    # products (rows then cols, same order as the oracle)
                    # instead of take-based row/col gathers.
                    self._grain_mx = True
                    xlo, xf = oops.bilinear_taps(gw, w)
                    rw = np.zeros((gw, w), np.float32)
                    np.add.at(rw, (xlo, np.arange(w)), 1.0 - xf)
                    np.add.at(rw, (np.minimum(xlo + 1, gw - 1), np.arange(w)), xf)
                    if self._grain_lerp:
                        c["grain_rh2"] = jnp.asarray(self.grain_row_matrix(
                            h, gh + 2, g, self.GRAIN2_ROWS)).astype(
                                jnp.bfloat16)
                        c["grain_rw_bf"] = jnp.asarray(rw).astype(
                            jnp.bfloat16)
                    else:
                        c["grain_rw"] = jnp.asarray(rw)
                        ylo, yf = oops.bilinear_taps(gh, h)
                        rh = np.zeros((h, gh), np.float32)
                        np.add.at(rh, (np.arange(h), ylo), 1.0 - yf)
                        np.add.at(rh, (np.arange(h),
                                       np.minimum(ylo + 1, gh - 1)), yf)
                        c["grain_rh"] = jnp.asarray(rh)

        if p.warp_on:
            map_x, map_y = oracle.barrel_warp_maps(h, w, p.warp_strength)
            x0, fx = oops.split_map(map_x)
            y0, fy = oops.split_map(map_y)
            c["warp"] = tuple(jnp.asarray(a) for a in (y0, x0, fy, fx))

        if p.glitch_on:
            y0, rows = oracle.glitch_rows(h, p.glitch_height_frac)
            self._glitch_y0, self._glitch_rows = y0, rows
            if rows > 0:
                ridx = np.arange(rows, dtype=np.float32)
                if self.engine == "preview":
                    amp = float(p.glitch_amp_px) * np.exp(-3.0 * (ridx / max(1.0, float(rows))))
                else:
                    amp = float(p.glitch_amp_px) * (1.0 - ridx / max(1.0, float(rows)))
                    seg_len = max(8, min(32, w // 120 if w >= 120 else 8))
                    self._glitch_num_segs = (w + seg_len - 1) // seg_len
                    c["glitch_seg_index"] = jnp.asarray(
                        (np.arange(w, dtype=np.int32) // seg_len).astype(np.int32)
                    )
                c["glitch_amp"] = jnp.asarray(amp.astype(np.float32))

        if text_rgba is not None and self.params.text.enabled:
            ov = np.asarray(text_rgba)
            if ov.shape[:2] != (h, w):
                raise ValueError(f"text overlay shape {ov.shape[:2]} != frame {(h, w)}")
            c["text_alpha"] = jnp.asarray(ov[..., 3:4].astype(np.float32) / 255.0)
            c["text_rgb"] = jnp.asarray(ov[..., :3].astype(np.float32) / 255.0)
        self._has_text = "text_alpha" in c
        self._c = c

    @property
    def _base_key(self):
        """Base RNG key, re-derived from the Python-int seed INSIDE the
        trace (threefry seeding is deterministic, ~2 fused ops) rather
        than captured as a device-resident closure constant, which
        lowering would have to fetch back to the host.

        PCRT_RNG_IMPL selects the PRNG implementation for the NATIVE
        rng mode (default threefry2x32). "rbg" (XLA's RngBitGenerator)
        is opt-in only: under vmap its draws are a function of the whole
        batched call shape, not of each frame's folded key (running
        test_native_rng_resume_invariant with rbg shows 32% of pixels
        differ when the same frames are re-rendered in a different batch
        split). That breaks the batch-, shard- and segment-resume
        invariance rng="native" promises (draws must be a pure function
        of (seed, frame_idx)). threefry is counter-based per element, so
        the invariance holds for any batch/shard split; the test pins
        it."""
        impl = os.environ.get("PCRT_RNG_IMPL")
        return jax.random.key(self.seed, impl=impl) if impl \
            else jax.random.key(self.seed)

    # ------------------------------------------------------------------
    # Per-frame chain (vmapped over the batch axis)
    # ------------------------------------------------------------------

    def _frame_pre_bloom(self, c: dict, frame_u8: jax.Array, aux_row) -> jax.Array:
        """Stages 1-5 for one frame (vmapped).

        Stages 2-3 (aberration roll, pixelate gather) are static index
        maps, which commute with the /255 convert — so they run on the
        UINT8 input (4x less roll/gather traffic than after stage 1),
        with aberration composed into pixelate's per-channel x maps
        when both are on. Values are bit-identical either way."""
        p = self.params
        x = frame_u8

        if p.pixelate_on:  # stages 2+3 composed
            ys, xss = self._pix_shifts
            if self._pix_chan_maps:
                maps = (c["pix_x_r"], c["pix_x"], c["pix_x_b"])
                chans = []
                for ci in range(3):
                    if ys is not None and xss[ci] is not None:
                        chans.append(oresize.remap_nearest_rolls(
                            x[..., ci], c["pix_y"], maps[ci], ys, xss[ci]))
                    else:
                        chans.append(oresize.remap_nearest(
                            x[..., ci], c["pix_y"], maps[ci]))
                x = jnp.stack(chans, axis=-1)
            elif ys is not None and xss[1] is not None:
                x = oresize.remap_nearest_rolls(x, c["pix_y"], c["pix_x"], ys, xss[1])
            else:
                x = oresize.remap_nearest(x, c["pix_y"], c["pix_x"])
        elif p.aberration_on:  # stage 2 alone: wrap rolls on uint8
            x = jnp.stack(
                [
                    jnp.roll(x[..., 0], p.aberration_px, axis=1),
                    x[..., 1],
                    jnp.roll(x[..., 2], -p.aberration_px, axis=1),
                ],
                axis=-1,
            )

        img = x.astype(jnp.float32) / 255.0  # stage 1

        img = ocolor.color_adjust(  # stage 4
            img, p.brightness, p.contrast, p.gamma, p.saturation, p.temperature
        )

        if self._has_text and not p.text.after:  # stage 5
            img = ocolor.composite_text(img, c["text_alpha"], c["text_rgb"])
        return img

    def _frame_bloom_xla(self, c: dict, img: jax.Array) -> jax.Array:
        """Stage 6 for one frame (vmapped)."""
        p = self.params
        src = img
        if p.bloom_threshold > 0.0:
            thr = np.float32(min(0.99, max(0.0, p.bloom_threshold)))
            src = jnp.clip((img - thr) / np.float32(max(1e-6, 1.0 - float(thr))), 0.0, 1.0)
        if p.fast_bloom:
            ds = oresize.resize_bilinear(src, *c["bloom_down"])
            blurred = oresize.resize_bilinear(ds, *c["bloom_up"])
        else:
            blurred = oblur.gaussian_blur_replicate(src, self._bloom_taps, self._bloom_taps)
        return jnp.clip(img + np.float32(p.bloom_strength) * blurred, 0.0, 1.0)

    def _frame_post_bloom(self, c: dict, img: jax.Array, aux_row) -> jax.Array:
        """Stages 7-11 for one frame (vmapped)."""
        p = self.params
        frame_idx, phase, flicker, noise, g_base, g_seg = aux_row

        if p.triad_on:  # stage 7
            img = ocolor.apply_triad(
                img, c["triad"], p.triad_gamma, p.triad_preserve_luma, self.lut_exact
            )

        if p.scanlines_on:  # stage 8
            if p.scanlines_1d:
                sl = self._scanline_mul_1d(c, phase)
                img = jnp.clip(img * sl[:, None, None], 0.0, 1.0)
            else:
                s = 0.5 * (1.0 + jnp.sin(self._sl_omega * (c["sl_slant"] + phase)))
                shaped = jnp.power(s, self._sl_inv_sharp)
                sl2 = 1.0 - np.float32(p.scanline_strength) * shaped
                img = jnp.clip(img * sl2[:, :, None], 0.0, 1.0)

        if p.vignette_on:  # stage 9
            r2 = c["vig_ny2"][:, None] + c["vig_nx2"][None, :]
            v = 1.0 - self._vig_strength * jnp.clip(r2, 0.0, 1.0)
            img = jnp.clip(img * v[:, :, None], 0.0, 1.0)

        if p.flicker_on:  # stage 10
            img = jnp.clip(img * flicker, 0.0, 1.0)

        if p.noise_on:  # stage 11
            field = self._grain_field(c, frame_idx, noise)
            field = field * np.float32(p.noise_strength / 255.0)
            img = jnp.clip(img + field[:, :, None], 0.0, 1.0)

        # stages 12-14 (warp, text-after, glitch) run at batch level in
        # _batch_effects.
        return img

    def _scanline_mul_1d(self, c: dict, phase) -> jax.Array:
        """Stage-8 1-D scanline multiplier (H,) for one frame."""
        s = 0.5 * (1.0 + jnp.sin(self._sl_omega * (c["sl_y"] + phase)))
        return 1.0 - np.float32(self.params.scanline_strength) * s

    # (W-window index offset, row frac) per output-row residue k: for
    # g=2, full[2q] = 0.25*W[q] + 0.75*W[q+1] and full[2q+1] =
    # 0.75*W[q+1] + 0.25*W[q+2], where W = half padded with one
    # edge-replicated row on top (the replicate pad reproduces oracle
    # bilinear_taps' lo-clip/frac-clip edge rows: both reduce to the
    # edge row's value).
    GRAIN2_ROWS = ((0, np.float32(0.75)), (1, np.float32(0.25)))

    @staticmethod
    def grain_row_matrix(rows: int, cols: int, g: int, taps) -> np.ndarray:
        """(rows, cols) bf16 row-upsample matrix over a padded window:
        row r = q*g+k carries (1-frac[k], frac[k]) at cols (q+off[k],
        q+off[k]+1). With bf16-exact weights and bf16 operands each
        product is exact in f32, the padding zeros add exactly, and the
        single p1+p2 rounding is order-free, so any accumulation order
        gives the same f32."""
        m = np.zeros((rows, cols), np.float32)
        for k, (off, fr) in enumerate(taps):
            rr = np.arange(k, rows, g)
            qq = rr // g
            m[rr, qq + off] = 1.0 - fr
            m[rr, qq + off + 1] = fr
        return m

    def _grain_rows_full(self, c: dict, half: jax.Array) -> jax.Array:
        """(gh, W) half-field -> (2*gh, W) row-upsampled field via the
        bf16 row-matrix dot (exact bilinear for H == 2*gh, cf.
        oracle/ops.py bilinear_taps)."""
        halp = jnp.concatenate([half[:1], half, half[-1:]], 0)
        return jax.lax.dot(c["grain_rh2"], halp.astype(jnp.bfloat16),
                           preferred_element_type=jnp.float32)

    def _grain_field(self, c: dict, frame_idx, noise) -> jax.Array:
        """Stage-11 un-scaled grain field (H, W) for one frame: generate
        (native rng) or take the host field, then upsample."""
        p = self.params
        gh, gw = self._grain_hw
        if noise is None:
            key = jax.random.fold_in(self._base_key, frame_idx)
            # PCRT_GRAIN_DRAW=bf16: draw the normal field at bf16 (16
            # random bits/element -> half the threefry work; the values
            # land on the bf16 grid the lerp dots truncate to anyway)
            # and widen to f32 for the shared downstream paths.
            # Distribution-legal for rng="native" (PARITY.md); an A/B
            # knob.
            dt = (jnp.bfloat16 if os.environ.get("PCRT_GRAIN_DRAW") == "bf16"
                  else jnp.float32)
            field = _draw_normal(jax.random.fold_in(key, 11), gh, gw, dt)
        else:
            field = noise
        if p.grain_size > 1:
            if self._grain_roll:
                field = oresize.resize2x_roll(field, *c["grain_wy"],
                                              *c["grain_wx"])
            elif self._grain_mx:
                if self._grain_lerp:
                    # explicit bf16 operands: 2-nonzero contractions
                    # with bf16-exact weights are order-free in f32
                    # accumulation (grain_row_matrix)
                    hf = jax.lax.dot(
                        field.astype(jnp.bfloat16), c["grain_rw_bf"],
                        preferred_element_type=jnp.float32)
                    field = self._grain_rows_full(c, hf)
                else:
                    # f32 operands: full f32 precision, never TF32
                    hi = jax.lax.Precision.HIGHEST
                    field = jnp.matmul(
                        jnp.matmul(c["grain_rh"], field, precision=hi),
                        c["grain_rw"], precision=hi)
            else:
                field = oresize.resize_bilinear(field, *c["grain_taps"])
        return field

    def _glitch_seg_offsets(self, frame_idx, g_base, g_seg, c):
        """Per-frame glitch offsets at segment granularity: (rows, S)
        export / (rows, 1) preview. base + seg is constant within a
        segment, so per-segment values fully determine the per-pixel map
        (via the static segment index) and per-segment rint equals the
        reference's per-pixel rint (crt_filter.py:853-855)."""
        rows = self._glitch_rows
        amp = c["glitch_amp"]
        if self.engine == "preview":
            if g_base is None:
                key = jax.random.fold_in(self._base_key, frame_idx)
                offs = oglitch.native_preview_offsets(jax.random.fold_in(key, 14), rows, amp)
            else:
                offs = g_base
            return offs[:, None]  # (rows, 1)
        if g_base is None or g_seg is None:
            key = jax.random.fold_in(self._base_key, frame_idx)
            base, seg = oglitch.native_export_fields(
                jax.random.fold_in(key, 14), rows, self._glitch_num_segs, amp
            )
        else:
            base, seg = g_base, g_seg
        return base[:, None] + seg  # (rows, S)

    def _batch_effects(self, frames_u8, aux: FrameAux, c: dict):
        """Full stateless chain over a batch: vmapped per-frame stages
        1-11, then warp (12), text-after (13) and glitch (14)."""
        p = self.params
        imgs = jax.vmap(functools.partial(self._frame_pre_bloom, c))(frames_u8, aux)
        if p.bloom_on:  # stage 6
            imgs = jax.vmap(functools.partial(self._frame_bloom_xla, c))(imgs)
        imgs = jax.vmap(functools.partial(self._frame_post_bloom, c))(imgs, aux)

        if p.warp_on:  # stage 12
            imgs = jax.vmap(
                lambda im: owarp.bilinear_gather_const0(im, *c["warp"])
            )(imgs)

        if self._has_text and p.text.after:  # stage 13 (broadcasts over B)
            imgs = ocolor.composite_text(imgs, c["text_alpha"], c["text_rgb"])

        if p.glitch_on and self._glitch_rows > 0:  # stage 14
            seg_offs = jax.vmap(
                lambda fi, gb, gs: self._glitch_seg_offsets(fi, gb, gs, c)
            )(aux.frame_idx, aux.glitch_base, aux.glitch_seg)  # (B, rows, S)
            if self.engine == "preview":
                per_px = seg_offs[:, :, 0]
            else:
                per_px = jnp.take(seg_offs, c["glitch_seg_index"], axis=2)
            imgs = jax.vmap(
                lambda im, o: oglitch.shear_band(im, self._glitch_y0, o)
            )(imgs, per_px)
        return imgs

    # ------------------------------------------------------------------
    # Batched step with persistence scan
    # ------------------------------------------------------------------

    def _finish(self, imgs, state, first_arr):
        """Persistence over the batch axis + uint8 cast (stage 15)."""
        p = self.params
        if not p.persistence_on:
            # no blend reads the carry: keep the quantized last output
            # frame, which is the same bits in every layout and shard
            # split (the f32 chain can round differently per fusion)
            out = ocolor.to_uint8(imgs)
            return out, out[-1].astype(jnp.float32) * np.float32(1.0 / 255.0)
        pp = np.float32(p.persistence)
        om = np.float32(1.0 - p.persistence)
        first = first_arr[0]

        def blend(prev, cur):
            b = jnp.clip(pp * prev + om * cur, 0.0, 1.0)
            return b, b

        # First frame of a stream has no previous state: it passes
        # through unblended (crt_filter.py:1094-1095). `first` is a
        # traced flag so one compiled program serves both cases.
        out0 = jnp.where(
            first, imgs[0], jnp.clip(pp * state + om * imgs[0], 0.0, 1.0)
        )
        if self.assoc_scan:
            rest = self._assoc_persistence(imgs[1:], out0)
        else:
            _, rest = jax.lax.scan(blend, out0, imgs[1:])
        outs = jnp.concatenate([out0[None], rest], axis=0)
        return ocolor.to_uint8(outs), outs[-1]

    def _step(self, frames_u8, aux: FrameAux, state, first_arr, c: dict):
        if self.layout == "planar":
            # convert at the step edges; the body runs NHWC in RGB order
            # (inv[c] = which plane holds color c; XLA folds the channel
            # permute into the same relayout copy)
            pc = np.array(self._plane_colors)
            inv = np.argsort(pc)
            frames_u8 = jnp.transpose(frames_u8, (0, 2, 3, 1))[..., inv]
            state = jnp.transpose(state, (1, 2, 0))[..., inv]
            out, ns = self._finish(
                self._batch_effects(frames_u8, aux, c), state, first_arr
            )
            return (jnp.transpose(out[..., pc], (0, 3, 1, 2)),
                    jnp.transpose(ns[..., pc], (2, 0, 1)))
        return self._finish(self._batch_effects(frames_u8, aux, c), state, first_arr)

    def _multi_step(self, frames_stack, aux_stack, state, first_arr, c: dict):
        """N sequential _step chunks inside ONE compiled dispatch.

        frames_stack: (n, B, ...) uint8; aux_stack: FrameAux whose
        leaves carry a leading (n, B, ...); state/first_arr as in
        _step. Returns ((n, B, ...) uint8 outputs, final state).

        lax.scan threads the persistence state chunk-to-chunk exactly
        like n successive _step calls (the first-frame flag drops after
        chunk 0), so the math is identical — the point is dispatch
        amortization: the per-call launch overhead is paid once per n
        chunks while the per-iteration working set stays one chunk.
        Used by the pipeline's steps_per_call batching and bench.py.
        """

        def body(carry, xs):
            st, first = carry
            frames, aux = xs
            out, ns = self._step(frames, aux, st, first, c)
            return (ns, jnp.zeros_like(first)), out

        (ns, _), outs = jax.lax.scan(
            body, (state, first_arr), (frames_stack, aux_stack))
        return outs, ns

    def _assoc_persistence(self, imgs, state0):
        """O(log B) associative scan for s_t = p*s_{t-1} + (1-p)*x_t.

        The pair (A, b) composes as (A2*A1, A2*b1 + b2); the clip in the
        reference is a mathematical no-op (convex combination of [0,1]
        values), applied once at the end for safety.
        """
        p = np.float32(self.params.persistence)
        om = np.float32(1.0 - self.params.persistence)
        n = imgs.shape[0]
        A = jnp.full((n,) + (1,) * (imgs.ndim - 1), p, imgs.dtype)
        b = om * imgs

        def combine(x, y):
            ax, bx = x
            ay, by = y
            return ax * ay, ay * bx + by

        As, bs = jax.lax.associative_scan(combine, (A, b), axis=0)
        return jnp.clip(As * state0[None] + bs, 0.0, 1.0)

    # ------------------------------------------------------------------
    # Host API
    # ------------------------------------------------------------------

    def make_aux(self, frame_indices: np.ndarray) -> FrameAux:
        """Build per-frame dynamic inputs for the given absolute frame
        indices. Host f64 scalar math matches the reference exactly
        (phase: crt_filter.py:1043, flicker: :632, time: :1064)."""
        p = self.params
        idx = np.asarray(frame_indices, dtype=np.int64)
        t = idx / float(self.fps)
        # keep the f64 phase: the reference seeds the glitch RNG from
        # int(|phase|*k) of the f64 value (crt_filter.py:841/:670), and a
        # f32 round near an integer boundary would flip the whole frame's
        # glitch field
        phase64 = t * p.scanline_speed_px_s
        phase = phase64.astype(np.float32)
        if p.flicker_on:
            flicker = (
                1.0 + 0.25 * p.flicker_strength * np.sin(2.0 * np.pi * p.flicker_hz * t)
            ).astype(np.float32)
        else:
            flicker = np.ones(idx.shape[0], np.float32)

        noise = g_base = g_seg = None
        if self.rng == "host":
            if p.noise_on:
                gh, gw = self._grain_hw
                # independent per-frame streams keyed by frame index
                noise = np.stack(
                    [
                        np.random.default_rng((self.seed, int(i))).standard_normal(
                            (gh, gw), dtype=np.float32
                        )
                        for i in idx
                    ]
                )
            if p.glitch_on and self._glitch_rows > 0:
                if self.engine == "preview":
                    g_base = np.stack(
                        [
                            oracle.glitch_offsets_preview(
                                self.h, self.w, float(ph), p.glitch_amp_px, p.glitch_height_frac
                            )
                            for ph in phase64
                        ]
                    )
                else:
                    bases, segs = [], []
                    for ph in phase64:
                        base, seg, _ = oracle.glitch_fields_export(
                            self.h, self.w, float(ph), p.glitch_amp_px, p.glitch_height_frac
                        )
                        bases.append(base)
                        segs.append(seg)
                    g_base, g_seg = np.stack(bases), np.stack(segs)

        return FrameAux(
            frame_idx=jnp.asarray(idx.astype(np.int32)),
            phase=jnp.asarray(phase),
            flicker=jnp.asarray(flicker),
            noise=None if noise is None else jnp.asarray(noise),
            glitch_base=None if g_base is None else jnp.asarray(g_base),
            glitch_seg=None if g_seg is None else jnp.asarray(g_seg),
        )

    def make_aux_at(self, times_sec, noise_fields=None) -> FrameAux:
        """Aux rows for arbitrary TIME positions. The GUI preview runs
        on wall-clock time rather than frame indices (reference on_tick,
        crt_filter.py:1810-1852), so phase/flicker derive from the given
        f64 times with the same formulas as make_aux, and host-rng noise
        takes INJECTED per-frame fields (the preview's time-seeded
        grain, gui_qt.render_preview_frame) instead of index-keyed
        draws. frame_idx is the nearest frame number (only native-rng
        keys read it)."""
        p = self.params
        t = np.asarray(times_sec, dtype=np.float64)
        phase64 = t * p.scanline_speed_px_s
        phase = phase64.astype(np.float32)
        if p.flicker_on:
            flicker = (1.0 + 0.25 * p.flicker_strength
                       * np.sin(2.0 * np.pi * p.flicker_hz * t)
                       ).astype(np.float32)
        else:
            flicker = np.ones(t.shape[0], np.float32)
        noise = g_base = g_seg = None
        if self.rng == "host":
            if p.noise_on:
                if noise_fields is None:
                    raise ValueError(
                        "host-rng preview aux needs injected noise_fields")
                noise = np.asarray(noise_fields, np.float32)
            if p.glitch_on and self._glitch_rows > 0:
                if self.engine == "preview":
                    g_base = np.stack([
                        oracle.glitch_offsets_preview(
                            self.h, self.w, float(ph), p.glitch_amp_px,
                            p.glitch_height_frac)
                        for ph in phase64])
                else:
                    bases, segs = [], []
                    for ph in phase64:
                        base, seg, _ = oracle.glitch_fields_export(
                            self.h, self.w, float(ph), p.glitch_amp_px,
                            p.glitch_height_frac)
                        bases.append(base)
                        segs.append(seg)
                    g_base, g_seg = np.stack(bases), np.stack(segs)
        return FrameAux(
            frame_idx=jnp.asarray(np.rint(t * self.fps).astype(np.int32)),
            phase=jnp.asarray(phase),
            flicker=jnp.asarray(flicker),
            noise=None if noise is None else jnp.asarray(noise),
            glitch_base=None if g_base is None else jnp.asarray(g_base),
            glitch_seg=None if g_seg is None else jnp.asarray(g_seg),
        )

    def process_at(self, frames_u8, times_sec, noise_fields=None,
                   state=None):
        """process() addressed by TIME instead of frame index (the GUI
        preview's access pattern — see make_aux_at). Same compiled step."""
        frames_u8 = jnp.asarray(frames_u8)
        aux = self.make_aux_at(times_sec, noise_fields)
        first = state is None
        if first:
            state = self.init_state()
        return self._jstep(
            frames_u8, aux, state, jnp.full((1,), first, jnp.bool_), self._c
        )

    def init_state(self) -> jax.Array:
        if self.layout == "planar":
            return jnp.zeros((3, self.h, self.w), jnp.float32)
        return jnp.zeros((self.h, self.w, 3), jnp.float32)

    def process(self, frames_u8, frame_indices=None, state=None):
        """Run a batch. frames_u8: (B, H, W, 3) uint8 (numpy or device)
        — or (B, 3, H, W) when the engine was built with layout="planar"
        (output and state shapes follow the same layout).
        Returns (out_u8 (B, H, W, 3) device array, new_state).

        Pass state=None for the first batch of a stream; thereafter pass
        the returned state to carry the persistence tail across batches.
        """
        frames_u8 = jnp.asarray(frames_u8)
        exp = ((3, self.h, self.w) if self.layout == "planar"
               else (self.h, self.w, 3))
        if frames_u8.shape[1:] != exp:
            raise ValueError(
                f"frames shape {frames_u8.shape[1:]} != {exp} for "
                f"layout={self.layout!r}")
        b = frames_u8.shape[0]
        if frame_indices is None:
            frame_indices = np.arange(b)
        aux = self.make_aux(np.asarray(frame_indices))
        first = state is None
        state_exp = ((3, self.h, self.w) if self.layout == "planar"
                     else (self.h, self.w, 3))
        if first:
            state = self.init_state()
        elif tuple(jnp.asarray(state).shape) != state_exp:
            # Stated deviation (PARITY.md): the reference bilinearly
            # resizes a shape-mismatched persistence carry mid-stream
            # (crt_filter.py:689-693 — a GUI-preview situation where the
            # preview size changes under a running stream). The export
            # engine compiles for ONE static shape, so it refuses
            # instead; the GUI preview path renders through the oracle,
            # which implements the resize-blend (oracle.persistence_blend).
            # (Static tuple compare — an init_state() call here would
            # allocate a full device zeros per steady-state batch.)
            raise ValueError(
                f"persistence state shape {jnp.asarray(state).shape} != "
                f"{state_exp}: CRTEngine does not resize a "
                "mid-stream carry (documented deviation, PARITY.md; the "
                "oracle/GUI preview path does)")
        return self._jstep(
            frames_u8, aux, state, jnp.full((1,), first, jnp.bool_), self._c
        )

    def process_stack(self, frames_stack, frame_indices, state=None):
        """Run n sequential chunks in ONE device dispatch (_multi_step).

        frames_stack: (n, B, H, W, 3) uint8 — or (n, B, 3, H, W) for
        layout="planar". frame_indices: (n, B) absolute frame indices.
        Returns ((n, B, ...) uint8 outputs, final persistence state) —
        bitwise identical to n successive process() calls (tested); the
        point is one dispatch's launch overhead per n chunks.
        """
        frames_stack = jnp.asarray(frames_stack)
        n, b = frames_stack.shape[0], frames_stack.shape[1]
        exp = ((3, self.h, self.w) if self.layout == "planar"
               else (self.h, self.w, 3))
        if frames_stack.shape[2:] != exp:
            raise ValueError(
                f"frames shape {frames_stack.shape[2:]} != {exp} for "
                f"layout={self.layout!r}")
        idx = np.asarray(frame_indices).reshape(n, b)
        aux = self.make_aux(idx.reshape(-1))
        aux = jax.tree.map(
            lambda a: jnp.reshape(a, (n, b) + a.shape[1:]), aux)
        first = state is None
        if first:
            state = self.init_state()
        return self._jmstep(
            frames_stack, aux, state, jnp.full((1,), first, jnp.bool_),
            self._c)

    def jitted_step(self):
        """The compiled step (frames, aux, state, first_arr, consts) ->
        (out_u8, state) — for benchmarking and sharded wrappers."""
        return self._jstep

    def jitted_multi_step(self):
        """The compiled n-chunk step (see _multi_step): stacked
        (n, B, ...) frames/aux in, (n, B, ...) outputs + final state
        out, one device dispatch per n chunks."""
        return self._jmstep
