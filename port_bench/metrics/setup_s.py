"""setup_s: seconds from the process's start to the end of the warm-up
(loading, weights, inputs, every build and compile, the warm-up calls),
by the host clock after a synchronize."""


def read(record):
    return record["setup_s"]
