"""Environment self-check of the port: ``python -m simple_vae_rs_tpu_torch.doctor``.

One screen that says whether this machine is ready to train and serve with
the port, and if not, what is missing: the Python and torch versions, the
CUDA card (its name and power limit as ``nvidia-smi`` reports them, and a
round trip through it), ``nvcc`` and whether each kernel source
(``csrc/*.cu``) builds, the native LZW codec, LPIPS weights, and
``msgpack`` (needed to read JAX checkpoints).

Exit code 0 when the card answered and every kernel built, 2 when no card
answered (as the JAX package's doctor), 1 when the card answered but a
kernel did not build: usable as a readiness gate, e.g.
``python -m simple_vae_rs_tpu_torch.doctor && python -m simple_vae_rs_tpu_torch.cli ...``.
"""

from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
import time


def _line(status: str, name: str, detail: str) -> None:
    print(f"  [{status:^4}] {name:<22} {detail}")


def nvidia_smi() -> str:
    """``name, power.limit`` of each card as ``nvidia-smi`` gives them, or
    why it could not say."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return "nvidia-smi not found"
    try:
        proc = subprocess.run([exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e!r}"
    text = (proc.stdout or proc.stderr).strip()
    return text if proc.returncode == 0 else f"nvidia-smi exited {proc.returncode}: {text}"


def run_checks() -> int:
    """Print the report; the exit code (see the module's doc)."""
    import numpy as np
    import torch

    print("simple-vae-rs-tpu (PyTorch/CUDA port) doctor")
    _line("ok", "python", sys.version.split()[0])
    _line("ok", "torch / numpy", f"{torch.__version__} (CUDA {torch.version.cuda}) / "
                                 f"{np.__version__}")

    # -- the card: a round trip through it
    card = False
    if torch.cuda.is_available():
        try:
            t0 = time.perf_counter()
            x = torch.ones(1024, device="cuda")
            float((x * 2).sum())
            ms = (time.perf_counter() - t0) * 1e3
            _line("ok", "CUDA card", f"{torch.cuda.get_device_name(0)} "
                                     f"x{torch.cuda.device_count()}; round trip {ms:.0f} ms")
            card = True
        except RuntimeError as e:
            _line("FAIL", "CUDA card", f"torch sees a card but it did not answer: {e}")
    else:
        _line("FAIL", "CUDA card", "torch.cuda.is_available() is False (pass --backend cpu "
                                   "to the command line to run on the host)")
    _line("ok" if card else "warn", "nvidia-smi", nvidia_smi())

    # -- nvcc and the kernel sources
    from simple_vae_rs_tpu_torch.ops import _build

    built_all = False
    try:
        nvcc = _build.nvcc_path()
        ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True, timeout=60)
        _line("ok", "nvcc", f"{nvcc} ({ver.stdout.strip().splitlines()[-1]})")
    except (RuntimeError, OSError, subprocess.TimeoutExpired) as e:
        _line("FAIL", "nvcc", str(e))
        nvcc = None
    sources = sorted(_build.CSRC.glob("*.cu"))
    if nvcc is not None:
        from concurrent.futures import ThreadPoolExecutor

        def build(src):
            t0 = time.perf_counter()
            try:
                _build._compile(src)
                return src.name, None, time.perf_counter() - t0
            except RuntimeError as e:
                return src.name, str(e).splitlines()[0], time.perf_counter() - t0

        with ThreadPoolExecutor(max_workers=max(1, len(sources))) as pool:
            results = list(pool.map(build, sources))
        for name, err, secs in results:
            _line("ok" if err is None else "FAIL", f"kernel {name}",
                  f"built ({secs:.1f} s, {_build.BUILD_ROOT})" if err is None else err)
        built_all = all(err is None for _, err, _ in results)
    else:
        _line("FAIL", "kernels", f"{len(sources)} sources in {_build.CSRC} need nvcc")

    # -- data codecs
    from simple_vae_rs_tpu_torch.data import lzw_native

    lib = lzw_native.get_lib()
    _line("ok" if lib is not None else "warn", "native LZW codec",
          f"built ({lzw_native.lib_path()})" if lib is not None
          else f"C build failed ({lzw_native.build_error}): the Python codec decodes, slowly")

    # -- optional subsystems
    from simple_vae_rs_tpu_torch.ops import lpips

    if lpips.load_weights() is not None:
        _line("ok", "LPIPS", f"weights at {lpips.weights_path()}")
    else:
        _line("warn", "LPIPS", f"no weights at {lpips.weights_path()}: the LPIPS metrics are "
                               "left out (never downloaded)")
    try:
        import msgpack

        _line("ok", "JAX checkpoints", f"msgpack {msgpack.version}")
    except ImportError:
        _line("warn", "JAX checkpoints", "msgpack not installed: .msgpack checkpoints unread")

    if not card:
        print("CUDA card UNREACHABLE")
        return 2
    print("all checks passed" if built_all else "a kernel did not build")
    return 0 if built_all else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m simple_vae_rs_tpu_torch.doctor",
                                 description="environment self-check (readiness gate)")
    ap.parse_args(argv)
    return run_checks()


if __name__ == "__main__":
    raise SystemExit(main())
