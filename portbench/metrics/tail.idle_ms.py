"""tail.idle_ms: device-idle milliseconds a call under the program's
``rwt.tail`` span (the component-min tail: coarsen, every round and its
flag read, the broadcast), at any nesting depth (harness/spans.py)."""

from harness.spans import idle_ms_per_call


def read(ctx):
    return idle_ms_per_call(ctx, "rwt.tail")
