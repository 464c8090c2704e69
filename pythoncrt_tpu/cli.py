"""Command-line interface.

Flag surface is name-for-name compatible with the reference CLI
(crt_filter.py:1153-1207), with the same defaults and the same clamp
semantics applied by the driver (:1225-1266). Additions:
--batch-size, --engine-mode, --rng, --seed, --assoc-scan, --precision,
--preset, --text-preset, --pipe-format, --segment-frames, --profile,
--sharding, --devices, --decode-workers, --steps-per-call, --check-deps,
and the batch surface --batch-manifest / --batch-journal /
--batch-retries (N clips rendered in lockstep through the clip-sharded
engine with journal resume — BASELINE.json config 5 as a product).
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

from .params import EffectParams, TextParams, load_preset, load_text_preset


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pythoncrt-tpu",
        description="CRT video effect renderer (JAX)",
    )
    p.add_argument("--input", type=str, default="")
    p.add_argument("--output", type=str)
    p.add_argument("--width", type=int, default=0)
    p.add_argument("--height", type=int, default=0)
    p.add_argument("--fps", type=int, default=0)
    p.add_argument("--scanline-strength", type=float, default=0.6)
    p.add_argument("--triad-strength", type=float, default=0.35)
    p.add_argument("--triad-gamma", type=float, default=2.2)
    p.add_argument("--triad-preserve-luma", action="store_true")
    p.add_argument("--triad-softness", type=float, default=0.5)
    p.add_argument("--aberration-px", type=int, default=1)
    p.add_argument("--bloom-sigma", type=float, default=1.2)
    p.add_argument("--bloom-strength", type=float, default=0.25)
    p.add_argument("--bloom-threshold", type=float, default=0.0)
    p.add_argument("--noise-strength", type=float, default=1.5)
    p.add_argument("--vignette-strength", type=float, default=0.25)
    p.add_argument("--persistence", type=float, default=0.2)
    p.add_argument("--crf", type=int, default=18)
    p.add_argument("--bitrate", type=int, default=0)
    p.add_argument("--scanline-speed", type=float, default=30.0)
    p.add_argument("--scanline-period", type=float, default=2.0)
    # the default rides on the ACTION (not p.set_defaults): parser-level
    # defaults bypass provided_flags' suppression, which made fast_bloom
    # look explicitly-passed on every run and silently beat presets
    p.add_argument("--fast-bloom", action="store_true", default=True)
    p.add_argument("--no-fast-bloom", dest="fast_bloom", action="store_false")
    p.add_argument("--pixel-size", type=int, default=2)
    p.add_argument("--brightness", type=float, default=0.0)
    p.add_argument("--contrast", type=float, default=1.0)
    p.add_argument("--gamma", type=float, default=1.0)
    p.add_argument("--saturation", type=float, default=1.0)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--flicker-strength", type=float, default=0.0)
    p.add_argument("--flicker-hz", type=float, default=0.0)
    p.add_argument("--grain-size", type=int, default=1)
    p.add_argument("--scanline-angle", type=float, default=0.0)
    p.add_argument("--scanline-thickness", type=float, default=1.0)
    p.add_argument("--warp-strength", type=float, default=0.0)
    p.add_argument("--text", type=str, default="")
    p.add_argument("--text-font", type=str, default="")
    p.add_argument("--text-size", type=int, default=36)
    p.add_argument("--text-color", type=str, default="#FFFFFF")
    p.add_argument("--text-x", type=int, default=32)
    p.add_argument("--text-y", type=int, default=32)
    p.add_argument("--text-after", action="store_true")
    p.add_argument("--gpu", action="store_true",
                   help="prefer a hardware host encoder (probe-verified)")
    p.add_argument("--nvenc-preset", type=str, default="p4")
    p.add_argument("--encoder", type=str, default="auto",
                   choices=["auto", "nvidia", "amd", "cpu"])
    p.add_argument("--decoder", type=str, default="auto",
                   choices=["auto", "nvidia", "amd", "intel", "cpu"])
    p.add_argument("--glitch-amp", type=int, default=0)
    p.add_argument("--glitch-height", type=float, default=0.0)
    p.add_argument("--gui", action="store_true")
    # --- additions to the reference surface ---
    p.add_argument("--check-deps", action="store_true",
                   help="report missing dependencies and exit (the "
                        "reference's import-time pip bootstrap, "
                        "redesigned as an explicit diagnostic)")
    p.add_argument("--preset", type=str, default="",
                   help="load an effect preset JSON (reference schema)")
    p.add_argument("--text-preset", type=str, default="",
                   help="load a text preset JSON (reference schema)")
    p.add_argument("--batch-size", type=int, default=16,
                   help="frames per device batch")
    p.add_argument("--engine-mode", type=str, default="export",
                   choices=["export", "preview"],
                   help="glitch algorithm variant (reference export/preview split)")
    p.add_argument("--rng", type=str, default="native", choices=["native", "host"],
                   help="noise/glitch randomness source")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--precision", type=str, default="exact",
                   choices=["exact", "fast"],
                   help="'exact' keeps <=1 LSB parity with the CPU "
                        "reference; 'fast' applies the triad gamma with "
                        "a direct pow instead of the reference's 1024-bin "
                        "LUT (up to a few LSB off, mostly near black)")
    p.add_argument("--assoc-scan", action="store_true",
                   help="O(log B) associative persistence scan (throughput mode)")
    p.add_argument("--pipe-format", type=str, default="rgb24",
                   choices=["rgb24", "yuv420p"],
                   help="rawvideo decode pipe format (yuv420p halves pipe "
                        "bandwidth; host converts via the native kernel)")
    p.add_argument("--segment-frames", type=int, default=0,
                   help="checkpoint the render every N frames (segment "
                        "files + resume journal; re-running the same "
                        "command resumes after a crash); 0 disables")
    p.add_argument("--profile", type=str, default="",
                   help="write an xprof/jax.profiler trace of the render "
                        "to this directory")
    p.add_argument("--sharding", type=str, default="auto",
                   choices=["auto", "none"],
                   help="'auto' shards each batch's frame axis across "
                        "visible devices; 'none' forces single-device")
    p.add_argument("--devices", type=int, default=0,
                   help="max devices to shard across (0 = all visible)")
    p.add_argument("--decode-workers", type=int, default=1,
                   help="parallel seek-positioned decode workers "
                        "(1080p@1000fps needs ~6 GB/s of RGB decode; one "
                        "decoder stream usually can't sustain it)")
    p.add_argument("--steps-per-call", type=int, default=0,
                   help="batch chunks scanned inside one device dispatch "
                        "(0 = auto: 4 single-device, 1 sharded/segmented)")
    p.add_argument("--batch-manifest", type=str, default="",
                   help="render a batch of clips from a JSON manifest "
                        "(list of {input, output?, width?, height?, "
                        "fps?, preset?, text_preset?}); jobs sharing "
                        "params/size/fps render in lockstep through "
                        "the clip-sharded engine, one clip per mesh "
                        "slot (BASELINE config 5); effect flags apply "
                        "to every job, a job's preset keys override "
                        "--preset/--text-preset as its base (explicit "
                        "flags still win, as in single-clip mode)")
    p.add_argument("--batch-journal", type=str, default="",
                   help="journal path for --batch-manifest resume "
                        "(default: <manifest>.journal.jsonl; 'none' "
                        "disables). Re-running the same command skips "
                        "clips already rendered")
    p.add_argument("--batch-retries", type=int, default=1,
                   help="per-clip retries for failed --batch-manifest "
                        "jobs (retries run on the sequential path)")
    return p


def provided_flags(argv=None) -> set:
    """Dest names of the options the user explicitly passed: a parallel
    parse with every default SUPPRESSed leaves only provided options in
    the namespace. Lets an explicit flag beat a --preset value even when
    the flag happens to equal the parser default."""
    sp = build_parser()
    for act in sp._actions:
        act.default = argparse.SUPPRESS
    sp._defaults.clear()  # parser-level set_defaults bypass the above
    ns, _ = sp.parse_known_args(argv)
    return set(vars(ns))


def params_from_args(a: argparse.Namespace, provided: set | None = None) -> EffectParams:
    """Assemble EffectParams from flags. Like the reference, explicit
    flags always win; the preset is the base. `provided` (from
    provided_flags) identifies explicitly-passed flags exactly; without
    it, a flag set to its parser default defers to the preset."""
    base = EffectParams()
    if a.preset:
        try:
            base, _ = load_preset(a.preset, base)
        except (OSError, ValueError) as e:
            raise SystemExit(f"failed to load preset {a.preset!r}: {e}")
    import dataclasses

    defaults = (build_parser().parse_args([]) if provided is None
                else None)  # only the no-provided fallback needs them

    def explicit(flag: str) -> bool:
        if provided is not None:
            return flag in provided
        return getattr(a, flag) != getattr(defaults, flag)

    t_base = TextParams()
    if a.text_preset:
        try:
            t_base = load_text_preset(a.text_preset)
        except (OSError, ValueError) as e:
            raise SystemExit(f"failed to load text preset {a.text_preset!r}: {e}")
    text_map = dict(text="text", text_font="font", text_size="size",
                    text_color="color", text_x="x", text_y="y",
                    text_after="after")
    t_upd = {}
    for flag, field in text_map.items():
        # same precedence as effect flags: the preset is the base,
        # explicitly-passed flags win (previously --text-preset
        # discarded explicit --text-* flags wholesale)
        if not a.text_preset or explicit(flag):
            t_upd[field] = getattr(a, flag)
    text = dataclasses.replace(t_base, **t_upd)
    flag_map = dict(
        scanline_strength="scanline_strength", triad_strength="triad_strength",
        triad_gamma="triad_gamma", triad_preserve_luma="triad_preserve_luma",
        triad_softness="triad_softness", aberration_px="aberration_px",
        bloom_sigma="bloom_sigma", bloom_strength="bloom_strength",
        bloom_threshold="bloom_threshold", noise_strength="noise_strength",
        vignette_strength="vignette_strength", persistence="persistence",
        scanline_speed="scanline_speed_px_s", scanline_period="scanline_period_px",
        fast_bloom="fast_bloom", pixel_size="pixel_size",
        brightness="brightness", contrast="contrast", gamma="gamma",
        saturation="saturation", temperature="temperature",
        flicker_strength="flicker_strength", flicker_hz="flicker_hz",
        grain_size="grain_size", scanline_angle="scanline_angle",
        scanline_thickness="scanline_thickness", warp_strength="warp_strength",
        glitch_amp="glitch_amp_px", glitch_height="glitch_height_frac",
    )
    updates = {}
    for flag, field in flag_map.items():
        if not a.preset or explicit(flag):
            updates[field] = getattr(a, flag)
    return dataclasses.replace(base, **updates, text=text).clamped()


def _run_batch(a: argparse.Namespace, argv) -> int:
    """--batch-manifest driver: manifest jobs -> batch.render_batch
    (journal resume + per-clip retry; homogeneous groups render through
    the clip-sharded multiclip.process_videos)."""
    import json

    mpath = Path(a.batch_manifest)
    if not mpath.exists():
        print("batch manifest not found", file=sys.stderr)
        return 2
    try:
        data = json.loads(mpath.read_text())
        if isinstance(data, dict):
            data = data["jobs"]
        if not isinstance(data, list) or not data:
            raise ValueError("manifest must be a non-empty list of jobs "
                             "(or {'jobs': [...]})")
    except (OSError, ValueError, KeyError) as e:
        print(f"failed to load batch manifest {a.batch_manifest!r}: {e}",
              file=sys.stderr)
        return 2

    prov = provided_flags(argv)
    params = params_from_args(a, prov)
    from .batch import ClipJob, render_batch

    kwargs = dict(
        crf=int(max(12, min(28, a.crf))),
        target_bitrate_kbps=int(max(0, a.bitrate)),
        gpu=bool(a.gpu),
        nvenc_preset=str(a.nvenc_preset),
        encoder_preference=str(a.encoder),
        decoder_preference=str(a.decoder),
        batch_size=max(1, int(a.batch_size)),
        engine_mode=str(a.engine_mode),
        rng=str(a.rng),
        seed=int(a.seed),
        precision=str(a.precision),
        pipe_format=str(a.pipe_format),
        devices=max(0, int(a.devices)),
        steps_per_call=int(a.steps_per_call),
    )
    # options outside the clip-sharded surface route the job through the
    # sequential per-clip path (batch.MULTI_CLIP_KWARGS) — silently
    # dropping them would override the user's explicit request
    if a.segment_frames > 0:
        kwargs["segment_frames"] = int(a.segment_frames)
    if a.decode_workers > 1:
        kwargs["decode_workers"] = int(a.decode_workers)
    if a.assoc_scan:
        kwargs["assoc_scan"] = True
    if a.sharding != "auto":
        kwargs["sharding"] = str(a.sharding)
    if a.profile:
        kwargs["profile_dir"] = str(a.profile)

    jobs = []
    for i, d in enumerate(data):
        try:
            inp = Path(d["input"])
        except (TypeError, KeyError):
            print(f"manifest job {i} has no 'input'", file=sys.stderr)
            return 2
        out = d.get("output") or str(inp.with_name(inp.stem + "_crt.mp4"))
        job_params = params
        if d.get("preset") or d.get("text_preset"):
            # per-job preset: the single-clip precedence, per job — the
            # job's preset replaces --preset/--text-preset as the base,
            # explicitly-passed flags still win. Distinct-preset jobs
            # land in distinct render groups (batch.py keys groups on
            # the full params), so mixed manifests stay correct.
            ja = argparse.Namespace(**vars(a))
            if d.get("preset"):
                ja.preset = str(d["preset"])
            if d.get("text_preset"):
                ja.text_preset = str(d["text_preset"])
            try:
                job_params = params_from_args(ja, prov)
            except SystemExit as e:
                print(f"manifest job {i}: {e}", file=sys.stderr)
                return 2
        try:
            jw = (int(d["width"]) if d.get("width")
                  else (a.width if a.width > 0 else None))
            jh = (int(d["height"]) if d.get("height")
                  else (a.height if a.height > 0 else None))
            jf = (float(d["fps"]) if d.get("fps")
                  else (a.fps if a.fps > 0 else None))
        except (TypeError, ValueError) as e:
            # the exit-2 manifest-error contract, not a raw traceback
            print(f"manifest job {i}: bad width/height/fps: {e}",
                  file=sys.stderr)
            return 2
        jobs.append(ClipJob(
            str(inp), str(out), job_params,
            width=jw, height=jh, fps=jf,
            kwargs=dict(kwargs),
        ))

    journal = a.batch_journal or str(mpath) + ".journal.jsonl"
    if journal == "none":
        journal = None
    t0 = time.perf_counter()
    results = render_batch(jobs, journal=journal,
                           max_retries=max(0, int(a.batch_retries)))
    n_ok = sum(r.ok for r in results)
    n_skip = sum(r.skipped for r in results)
    for r in results:
        tag = ("skipped (journal)" if r.skipped
               else "ok" if r.ok else "FAILED")
        print(f"{r.job.input_path} -> {r.job.output_path}: {tag}"
              + (f" [{r.seconds:.1f}s]" if not r.skipped else ""))
        if not r.ok and r.error:
            print(f"  {r.error.strip().splitlines()[-1]}", file=sys.stderr)
    print(f"{n_ok}/{len(results)} clips ok ({n_skip} resumed), "
          f"elapsed {time.perf_counter() - t0:.3f}s")
    return 0 if n_ok == len(results) else 5


def main(argv=None) -> int:
    a = build_parser().parse_args(argv)
    if a.check_deps:
        from .bootstrap import check_deps

        rep = check_deps()
        print(rep.render())
        return 0 if rep.ok else 4
    if a.batch_manifest:
        return _run_batch(a, argv)
    if a.gui or not a.input:
        from .gui import launch_gui

        return launch_gui()
    t0 = time.perf_counter()
    inp = Path(a.input)
    if not inp.exists():
        print("input not found", file=sys.stderr)
        return 2
    out = Path(a.output) if a.output else inp.with_name(inp.stem + "_crt.mp4")
    params = params_from_args(a, provided_flags(argv))

    from .pipeline import process_video

    used_gpu = process_video(
        inp, out, params,
        width=a.width if a.width > 0 else None,
        height=a.height if a.height > 0 else None,
        fps=a.fps if a.fps > 0 else None,
        crf=int(max(12, min(28, a.crf))),
        target_bitrate_kbps=int(max(0, a.bitrate)),
        gpu=bool(a.gpu),
        nvenc_preset=str(a.nvenc_preset),
        encoder_preference=str(a.encoder),
        decoder_preference=str(a.decoder),
        batch_size=max(1, int(a.batch_size)),
        engine_mode=str(a.engine_mode),
        rng=str(a.rng),
        seed=int(a.seed),
        assoc_scan=bool(a.assoc_scan),
        precision=str(a.precision),
        pipe_format=str(a.pipe_format),
        sharding=str(a.sharding),
        devices=max(0, int(a.devices)),
        decode_workers=max(1, int(a.decode_workers)),
        steps_per_call=int(a.steps_per_call),
        segment_frames=max(0, int(a.segment_frames)),
        profile_dir=a.profile or None,
    )
    print("Hardware encoder used" if used_gpu else "CPU encoder used")
    print(f"elapsed {time.perf_counter() - t0:.3f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
