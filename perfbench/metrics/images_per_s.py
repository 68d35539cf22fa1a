"""Images converted per second: every image the window completed over the
whole window (host clock); the window closes at the end of an image."""


def read(run):
    if not run.images or run.window_s <= 0:
        return None
    return len(run.images) / run.window_s
