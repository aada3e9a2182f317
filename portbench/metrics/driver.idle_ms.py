"""driver.idle_ms: device-idle milliseconds a call under the program's
``rwt.driver.relax`` span (the relax fixed point: its calls and their flag
reads), at any nesting depth (harness/spans.py)."""

from harness.spans import idle_ms_per_call


def read(ctx):
    return idle_ms_per_call(ctx, "rwt.driver.relax")
