"""Host milliseconds a step inside the harness's span around the batch's
copy to the card and ``rfnet_tpu_torch.train.train_step``, by the host clock over the
window's steps after the profiled slice, where the profiler is off."""


def read(sl):
    return sl.host_ms()
