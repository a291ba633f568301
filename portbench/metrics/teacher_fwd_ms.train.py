"""teacher_fwd_ms.train: device ms a step of the teacher's forwards, from
the traced window: the union of the device operations whose launch the
host made between the teacher's forward pre-hook and its forward hook
(matched to their launches by the trace's correlation ids), over the
traced steps."""


def read(ctx):
    t = ctx.trace
    seconds = t and t.launched_in("teacher.forward")
    return None if not seconds else 1e3 * seconds / t.units
