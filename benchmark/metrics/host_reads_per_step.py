"""Host reads of a device scalar a step (aten::_local_scalar_dense): each
one waits for the device."""


def read(trace):
    if not trace.steps or not trace.device:
        return None
    return trace.reads / trace.steps
