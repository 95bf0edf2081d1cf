"""The programs a cell's traffic names, on the CPU at a tiny size: the
plain FITS writer read back by the port's loader, ``align_fits`` on the
writer's files against ``align_images`` on the same frames, the restore
of the files between calls, ``prepare`` kept out of a call's wall, and
the reference refusing a stage it does not implement."""

import dataclasses
import time

import numpy as np
import pytest

from portbench import fitsfile, harness, reference, scene
from portbench.programs import align_fits
from portbench.tests.test_portbench_run import SEED, TINY, tiny_cell
from subpixal_tpu_torch.io.fits import read_fits
from subpixal_tpu_torch.pipeline import load_exposures


def _visit(files=None, planes=False):
    """A tiny visit whose frames carry distinct crpix, with ``files``,
    and with ERR and DQ planes where ``planes``."""
    st = scene.make_stack(TINY, scene.stack_seed(SEED, 0), "cpu")
    E = len(st.frames)
    st = dataclasses.replace(st, files=files, crpix=st.crpix + np.array(
        [[0.25 * e, -0.125 * e] for e in range(E)]))
    if planes:
        rng = np.random.default_rng(3)
        st.err = [rng.random(f.shape, np.float32) for f in st.frames]
        st.dq = [rng.integers(0, 512, f.shape).astype(np.int16)
                 for f in st.frames]
    return st


TWO_CHIPS = [("a.fits", 1), ("a.fits", 2), ("b.fits.gz", 1),
             ("b.fits.gz", 2)]


@pytest.mark.parametrize("files", [None, TWO_CHIPS])
def test_the_port_reads_the_writers_files_back_exactly(files, tmp_path):
    st = _visit(files, planes=True)
    paths = list(fitsfile.write_visit(st, str(tmp_path)))
    assert len(paths) == (4 if files is None else 2)
    exps = load_exposures(paths, err_ext="ERR")
    assert len(exps) == len(st.frames)
    for e, exp in enumerate(exps):
        assert exp.data.dtype == np.float32
        np.testing.assert_array_equal(exp.data.view(np.uint32),
                                      st.frames[e].view(np.uint32))
        np.testing.assert_array_equal(exp.err, st.err[e])
        assert exp.data_units == "rate" and exp.exptime == 1.0
        assert np.array_equal(exp.wcs.crpix, st.crpix[e])
        assert np.array_equal(exp.wcs.crval, st.crval)
        assert np.array_equal(exp.wcs.cd, st.cd)
    if files is not None:
        assert exps[1].name == f"{paths[0]}[sci,2]"
    for path, frames in zip(paths, fitsfile.visit_files(st).values()):
        hdul = read_fits(path)
        assert hdul[0].header["NEXTEND"] == 3 * len(frames)
        for chip, e in enumerate(frames, 1):
            np.testing.assert_array_equal(hdul["DQ", chip].data, st.dq[e])


def test_frames_out_of_file_order_are_refused():
    with pytest.raises(ValueError):
        fitsfile.visit_files(_visit([("a.fits", 1), ("b.fits", 1),
                                     ("a.fits", 2), ("b.fits", 2)]))
    with pytest.raises(ValueError):
        fitsfile.visit_files(_visit([("a.fits", 2), ("a.fits", 1),
                                     ("b.fits", 1), ("b.fits", 2)]))


def _at_points(c, q):
    """A call's answer applied to the test points q (P, 2)."""
    return np.einsum("eij,pj->epi", c["matrices"], q) + c["shifts"][:, None]


def test_align_fits_answers_as_align_images_and_is_correct():
    runs = {}
    for name in ("align_images", "align_fits"):
        cell = tiny_cell("batch")
        cell.traffic = dict(cell.traffic, program=name)
        assert cell.program().__name__.endswith(name)
        run, line = harness.run_cell(cell, SEED, 0.2, False, "cpu")
        assert line["correct"] is True, (name, line["checks"])
        runs[name] = run
    P = cell.spec["pool_stacks"]
    pool = cell.scene().make_pool(cell.config, SEED, P + 1, "cpu")[:P]
    base = {c["k"]: c for c in runs["align_images"].calls}
    seen = 0
    for c in runs["align_fits"].calls:
        if c["k"] not in base:
            continue
        _, qr = harness.visit_geometry(pool[c["k"]], reference)
        q = qr + (c["crpix"] - runs["align_fits"].refs[c["k"]].crpix)
        b = base[c["k"]]
        assert np.array_equal(c["crpix"], b["crpix"])
        gap = np.abs(_at_points(c, q) - _at_points(b, q)).max()
        assert gap <= 1e-6, (c["k"], gap)
        seen += 1
    assert seen >= 1


def test_align_fits_restores_the_files_between_calls(tmp_path):
    st = _visit(TWO_CHIPS)
    settings = dict(device_catalog="device")
    answers, written = [], None
    for _ in range(2):
        align_fits.prepare(st, settings, "cpu", 0, str(tmp_path))
        files = align_fits._WRITTEN[str(tmp_path / f"visit{st.index}")]
        if written is None:
            written = {p: b for p, b in files.items()}
        for path, blob in written.items():
            assert open(path, "rb").read() == blob
        res = align_fits.call(st, settings, "cpu", 0)
        answers.append((np.asarray(res.matrices), np.asarray(res.shifts)))
        # the call rewrote each file's headers with its corrected WCS
        assert all(open(p, "rb").read() != b for p, b in written.items())
    np.testing.assert_array_equal(answers[0][0], answers[1][0])
    np.testing.assert_array_equal(answers[0][1], answers[1][1])
    with pytest.raises(KeyError):   # a call with no prepare before it
        align_fits.call(st, settings, "cpu", 0)


def test_a_slow_prepare_stays_out_of_the_calls_wall():
    cell = tiny_cell("batch")
    real = cell.program()
    own = []

    def prepare(stack, settings, device, k, workdir):
        time.sleep(0.5)

    def call(stack, settings, device, k):
        t = time.perf_counter()
        res = real.call(stack, settings, device, k)
        own.append(time.perf_counter() - t)
        return res

    run, _ = harness.run_cell(cell, SEED, 0.1, False, "cpu",
                              program=harness.Program(call, prepare),
                              warm_up=False)
    walls = [run.first_call_s] + [c["wall"] for c in run.calls]
    assert len(walls) == len(own)
    for wall, inner in zip(walls, own):
        assert wall - inner < 0.25, (wall, inner)


@pytest.mark.parametrize("key", ["match_sky", "static_mask", "reject_cr"])
def test_the_reference_refuses_a_stage_it_does_not_implement(key):
    st = _visit()
    wcs = [reference.Tan(*w) for w in harness.visit_wcs(st)]
    with pytest.raises(ValueError, match=key):
        reference.align(st.frames, wcs, {key: True}, 1, "cpu")
    with pytest.raises(ValueError, match="skymethod"):
        reference.align(st.frames, wcs, {"skymethod": "localmin"}, 1, "cpu")
    reference.check_settings({key: False, "device_catalog": "device",
                              "fitgeom": "shift"})


@pytest.mark.parametrize("fault", ["unchanged_step", "half_frames",
                                   "answer_altered"])
def test_the_faults_wrap_the_cells_own_program(fault):
    from portbench import control
    cell = tiny_cell("batch")
    cell.traffic = dict(cell.traffic, program="align_fits")
    program, _, _ = control.PROGRAMS[fault](cell)
    assert harness.as_program(program).prepare is align_fits.prepare
    _, line = control.run(cell, fault, SEED, 0.2, "cpu")
    assert line["correct"] is False
    assert line["failed"] >= 1
