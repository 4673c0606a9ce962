"""Device-idle milliseconds a traced step while the host is inside the
program's `pt.step` span (forward, backward and update): the card
waiting for the host to issue the step."""

from perfbench import spans


def read(rec):
    red = rec.get("trace")
    if not red:
        return None
    return spans.idle_inside_ms(red, spans.named(red, "pt.step"))
