"""Device-idle milliseconds a traced pass while the host is inside the
program's `pt.pass` span and not inside its `pt.sync` (the pass's one
read of the card): the card waiting for the host to issue the pass."""

from perfbench import spans


def read(rec):
    red = rec.get("trace")
    if not red:
        return None
    host = spans.subtract(spans.named(red, "pt.pass"),
                          spans.named(red, "pt.sync"))
    return spans.idle_inside_ms(red, host)
