"""Environment self-check of the port: ``python -m simple_vae_rs_tpu_torch.doctor``.

One screen that says whether this machine is ready to train and serve with
the port, and if not, what is missing: the Python and torch versions, the
CUDA card (its name and power limit as ``nvidia-smi`` reports them, and the
first round trip through it, under the ``--budget`` deadline:
``utils/health.probe_backend``), ``nvcc`` and whether each kernel source
(``csrc/*.cu``) builds, the native LZW codec, LPIPS weights, and
``msgpack`` (needed to read JAX checkpoints). ``--backend cpu`` probes the
host instead (``serve.backend_device``, as the command line reads it).

Exit code 0 when the device answered and every kernel built (on the card),
2 when it did not answer within the budget (as the JAX package's doctor), 1
when the card answered but a kernel did not build: usable as a readiness
gate, e.g. ``python -m simple_vae_rs_tpu_torch.doctor --budget 60 && python
-m simple_vae_rs_tpu_torch.cli ...``.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import time
from typing import Tuple

from simple_vae_rs_tpu_torch.serve import backend_device
from simple_vae_rs_tpu_torch.utils import health


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


def run_checks(budget_s: float = 120.0, backend: str = "") -> Tuple[int, bool]:
    """Print the report; the exit code (see the module's doc), and whether
    the probe ran out of its budget (its thread may then be stuck in the
    CUDA runtime, and the interpreter's teardown with it). The device
    (``backend``: the card by default, or "cpu") must answer its first
    round trip within ``budget_s`` seconds."""
    import numpy as np
    import torch

    device = backend_device(backend)
    print("simple-vae-rs-tpu (PyTorch/CUDA port) doctor")
    _line("ok", "python", sys.version.split()[0])
    _line("ok", "torch / numpy", f"{torch.__version__} (CUDA {torch.version.cuda}) / "
                                 f"{np.__version__}")

    # -- the device: its first round trip, under the deadline
    t0 = time.monotonic()
    latency = health.probe_backend(budget_s, device=device, out=sys.stdout)
    stuck = latency is None and time.monotonic() - t0 >= budget_s
    card = latency is not None
    name = "CUDA card" if device == "cuda" else "host (--backend cpu)"
    if card:
        what = (f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}"
                if device == "cuda" else "the CPU")
        _line("ok", name, f"{what}; first round trip {latency * 1e3:.0f} ms")
    elif stuck:
        _line("FAIL", name, f"no answer within the {budget_s:g} s budget (--budget)")
    elif device == "cuda" and not torch.cuda.is_available():
        _line("FAIL", name, "torch.cuda.is_available() is False (pass --backend cpu "
                            "to the command line to run on the host)")
    else:
        _line("FAIL", name, "torch sees the device but it did not answer (above)")
    _line("ok" if card and device == "cuda" else "warn", "nvidia-smi", nvidia_smi())

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
        print(f"{name} UNREACHABLE (probe budget {budget_s:g} s)")
        return 2, stuck
    if device == "cpu":
        print("all checks passed for the host (the kernels run on the card only)")
        return 0, False
    print("all checks passed" if built_all else "a kernel did not build")
    return (0 if built_all else 1), False


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m simple_vae_rs_tpu_torch.doctor",
                                 description="environment self-check (readiness gate)")
    ap.add_argument("--budget", type=float, default=120.0,
                    help="deadline of the device's first round trip, seconds (default 120)")
    ap.add_argument("--backend", default="",
                    help="the device to probe: cuda (the default) or cpu")
    args = ap.parse_args(argv)
    code, stuck = run_checks(args.budget, args.backend)
    if stuck:
        # the probe's thread may sit in the CUDA runtime's initialization, where
        # the interpreter's teardown could hang or abort: leave at once
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(2)
    return code


if __name__ == "__main__":
    raise SystemExit(main())
