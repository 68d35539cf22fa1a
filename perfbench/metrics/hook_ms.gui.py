"""Milliseconds a step in the GUI's redraw (`preview.render_preview`, its
copies from the device and the composite), over the untraced steps."""


def read(run):
    steps = [s for s in run.steps if not s["traced"]]
    if not steps:
        return None
    return 1e3 * sum(s["hook_s"] for s in steps) / len(steps)
