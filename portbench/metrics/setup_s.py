"""setup_s: seconds from the process's start to the first timed request
(data, index build, warm-up, and in a checkout's first run the kernel
build)."""


def read(rec):
    return rec.get("setup_s")
