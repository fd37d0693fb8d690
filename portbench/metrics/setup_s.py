"""setup_s: seconds from the start of the process to the end of set-up
(imports, data made on the card, the program's build, every kernel
built and every shape of the window warmed), host clock."""


def read(run):
    return run.setup_s
