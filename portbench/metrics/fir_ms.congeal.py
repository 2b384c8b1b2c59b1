"""Device ms a congeal batch of the FIR resampler: the kernels whose name
holds ATen's ``conv_depthwise2d`` or the port's ``upfirdn2d``,
whichever implements it, summed over the traced window over its batches.
The 3-channel resamplers on depthwise convs (``bilinear_downsample``,
the pyramid's blur) count too."""

FIR_KERNELS = ("conv_depthwise2d", "upfirdn2d")


def read(trace):
    seconds, count = trace.kernel_seconds(*FIR_KERNELS)
    return 1e3 * seconds / trace.units if count else None
