"""fine_tail.idle_ms: device-idle milliseconds a call under the program's
``rwt.tail.fine`` span (the fine scan tail: every round and its flag
read), at any nesting depth (harness/spans.py).  None where the program
opened no such span."""

from harness.spans import idle_ms_per_call


def read(ctx):
    return idle_ms_per_call(ctx, "rwt.tail.fine")
