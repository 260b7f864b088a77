"""Seconds from the process's start to the window's opening: imports, the
weights drawn on the card, the server, the kernels built (a checkout's
first run) or loaded, and one warm-up batch of the mix's own shapes. End to
end."""

RANGES = []


def read(view):
    return view.setup_s
