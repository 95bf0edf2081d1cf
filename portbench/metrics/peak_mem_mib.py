"""peak_mem_mib: the most device memory the run's process held reserved
from the card (``torch.cuda.max_memory_reserved()``, graph pools
included) from the first call to the window's end, MiB. The benchmark
reads it from the device's allocator itself: no program span or
counter."""


def read(run):
    return run.memory_reserved_peak / 2 ** 20 if run.memory_reserved_peak \
        else None
