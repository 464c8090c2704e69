"""pythoncrt_tpu — CRT video effect framework on JAX.

A from-scratch JAX/XLA rebuild of the capabilities of
jaylikesbunda/PythonCRT (a CPU NumPy/OpenCV per-frame effect chain):
one fused batched effect engine, a CPU oracle defining ground-truth
bytes, host ffmpeg/cv2 media I/O overlapped with device compute, and
multi-device frame/clip sharding via jax.sharding.
"""

__version__ = "0.1.0"

from .params import EffectParams, TextParams, load_preset, save_preset  # noqa: F401
from .params import load_text_preset, save_text_preset  # noqa: F401


def __getattr__(name):
    # Lazy imports keep `import pythoncrt_tpu` light (no JAX import) for
    # CLI --help, preset tooling, and oracle-only use.
    import importlib

    if name in ("CRTEngine", "FrameAux"):
        return getattr(importlib.import_module(".engine", __name__), name)
    if name == "oracle":
        return importlib.import_module(".oracle", __name__)
    if name == "process_video":
        return getattr(importlib.import_module(".pipeline", __name__), name)
    if name == "process_videos":
        return getattr(importlib.import_module(".multiclip", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
