"""The port's ``align_images`` on a visit's frames in memory: host arrays,
or the card's copies where the traffic hands them over there."""

from portbench.harness import visit_wcs


def call(stack, settings, device, k):
    """The program under test: the port's ``align_images`` on the visit's
    frames (host arrays, or the card's copies where the pool keeps them)
    and their TAN WCS."""
    from subpixal_tpu_torch.align import align_images
    from subpixal_tpu_torch.resample import Exposure
    from subpixal_tpu_torch.wcs import TanWCS

    frames = stack.device_frames or stack.frames
    exps = [Exposure(f, TanWCS(crpix=c, crval=v, cd=d), name=f"v{k}e{e}")
            for e, (f, (c, v, d)) in enumerate(zip(frames,
                                                   visit_wcs(stack)))]
    return align_images(exposures=exps, device=device, **settings)
