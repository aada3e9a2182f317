"""Profiler tracing helpers on ``torch.profiler``.

Counterpart of ``rustronomy_watershed_tpu.utils.tracing`` (which wraps
``jax.profiler``): ``trace`` captures the enclosed block into a Chrome/
TensorBoard trace file (``tensorboard_trace_handler``), and
``step_annotation`` names a range in it (``record_function``).  The package
itself calls none of them, as the JAX package's builder does not.

Capture is verified, not assumed: ``trace`` warns LOUDLY (RuntimeWarning)
when the profiler fails to start or to stop, when ``check=True`` finds no
new trace file in the log dir, and when the session recorded CUDA kernel
launches but no kernel on the device (a session that is accepted but sees
nothing of the card; a second profiler session in one process can do
that).  A silently-empty trace is worse than no trace.
``trace_artifacts(log_dir)`` lists the captured ``*.pt.trace.json`` files
so callers (and tests) can assert on them.  One session a process is the
safe rule on a GPU host.
"""

from __future__ import annotations

import contextlib
import pathlib
import warnings

# CPU-side names of a kernel launch in a profiler session (runtime and
# driver API).
_LAUNCH_NAMES = ("cudaLaunchKernel", "cuLaunchKernel")


def trace_artifacts(log_dir) -> list:
    """The trace files a successful capture leaves under ``log_dir``
    (``tensorboard_trace_handler`` layout: ``<host>_<pid>.<ts>.pt.trace.json``).
    Empty list == nothing was captured."""
    return sorted(pathlib.Path(str(log_dir)).glob("**/*.pt.trace.json"))


def _events(prof) -> list:
    """``[(name, on_device)]`` of every event of a stopped session."""
    return [(e.name, e.device_type.name == "CUDA") for e in prof.events()]


def launches_without_kernels(events) -> bool:
    """Whether ``[(name, on_device)]`` holds a CUDA kernel launch on the
    host but no kernel on the device (copies and fills are not kernels)."""
    launched = any(not dev and name.startswith(_LAUNCH_NAMES) for name, dev in events)
    kernels = any(dev and not name.startswith(("Memcpy", "Memset")) for name, dev in events)
    return launched and not kernels


@contextlib.contextmanager
def trace(log_dir: str, check: bool = True):
    """Capture a ``torch.profiler`` trace of the enclosed block into
    ``log_dir``: CPU activity, and CUDA activity when
    ``torch.cuda.is_available()``.

    Never raises out of profiler plumbing (the enclosed computation runs
    regardless), but any capture failure is a loud RuntimeWarning:
    * the profiler refusing to start or to stop, or
    * ``check=True`` (default) finding no new ``*.pt.trace.json`` at stop
      time, or a session whose CPU events hold a kernel launch
      (``cudaLaunchKernel`` / ``cuLaunchKernel``) and which recorded no
      kernel on the device — a backend that accepts the session but
      exports nothing of the card.
    """
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    before = set(trace_artifacts(log_dir)) if check else set()
    prof = None
    try:
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(log_dir)))
        prof.start()
    except Exception as e:  # noqa: BLE001 — reported, not swallowed
        prof = None
        warnings.warn(
            f"torch.profiler failed to start on this platform ({e!r}); "
            "the transform will run UNTRACED",
            RuntimeWarning,
            stacklevel=3,
        )
    try:
        yield
    finally:
        if prof is not None:
            try:
                prof.stop()
            except Exception as e:  # noqa: BLE001
                warnings.warn(
                    f"torch.profiler failed to stop ({e!r}); the trace in "
                    f"{log_dir} may be incomplete",
                    RuntimeWarning,
                    stacklevel=3,
                )
            else:
                problem = _capture_problem(prof, log_dir, before) if check else None
                if problem:
                    warnings.warn(problem, RuntimeWarning, stacklevel=3)


def _capture_problem(prof, log_dir, before) -> str | None:
    """What is wrong with a stopped session's capture, or None."""
    if not (set(trace_artifacts(log_dir)) - before):
        return f"profiler session completed but produced no trace file under {log_dir}; treat the trace as absent"
    try:
        events = _events(prof)
    except Exception as e:  # noqa: BLE001
        return f"the profiler session's events could not be read ({e!r}); treat the trace under {log_dir} as suspect"
    if launches_without_kernels(events):
        return (f"profiler session recorded CUDA kernel launches but no kernel on the device (trace under "
                f"{log_dir}); this session saw nothing of the card, treat its device part as absent")
    return None


def step_annotation(name: str):
    """Named range (e.g. one water level) that shows up in trace viewers."""
    import torch

    return torch.profiler.record_function(name)
