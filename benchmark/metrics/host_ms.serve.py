"""Host milliseconds a batch inside the harness's span around
``rfnet_tpu_torch.eval.dispatch`` (the copy in, the forward's and the
metrics' launches, the read-back's queueing), by the host clock over the
window's batches after the profiled slice, where the profiler is off."""


def read(sl):
    return sl.host_ms()
