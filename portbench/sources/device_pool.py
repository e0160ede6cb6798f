"""``device_src``: the pool's windows are staged on the card once, as the
pipeline starts (set-up), and sent from there in turn with no host copy
in the timed window.  Closed loop: the next window enters when the
pipeline takes it."""


def head(traffic) -> str:
    return "device_src name=src"


def attach(p, frames, traffic):
    p["src"].frames = frames
    p["src"].pool_size = len(frames)
    return None
