"""setup.first_call_s: wall of the process's first ``align_images`` call
(eager programs and their captures, the loop's capture), s."""


def read(run):
    return run.first_call_s or None
