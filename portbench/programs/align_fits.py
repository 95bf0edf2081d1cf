"""The port's ``align_fits`` on a visit's FITS files, as pipelines call
it: the files read, the frames aligned, and each chip's SCI header
rewritten with its corrected WCS (the port's default).

``prepare`` writes the visit's files (``fitsfile.write_visit``) into the
run's work directory the first time it sees the visit; before every
later call it writes back their bytes as first written, since the call
before rewrote the headers.
"""

import os

from portbench import fitsfile

# The harness hands ``call`` no work directory, so the files a
# ``prepare`` laid out wait here for the call that follows it.
#: visit directory -> {path: the bytes first written}
_WRITTEN: dict = {}
#: id of a prepared stack -> its files, for the call that follows
_PREPARED: dict = {}


def prepare(stack, settings, device, k, workdir):
    """Write the visit's files, or restore them as first written."""
    vdir = os.path.join(workdir, f"visit{stack.index}")
    files = _WRITTEN.get(vdir)
    if files is None:
        for d in [d for d in _WRITTEN if not os.path.isdir(d)]:
            del _WRITTEN[d]     # an ended run's
        os.makedirs(vdir)
        files = _WRITTEN[vdir] = fitsfile.write_visit(stack, vdir)
    else:
        for path, blob in files.items():
            with open(path, "wb") as f:
                f.write(blob)
    _PREPARED[id(stack)] = list(files)


def call(stack, settings, device, k):
    """The program under test: the port's ``align_fits`` on the files
    ``prepare`` laid out for this visit."""
    from subpixal_tpu_torch.pipeline import align_fits

    return align_fits(_PREPARED.pop(id(stack)), device=device, **settings)
