"""Kernel C's (``csrc/kapply3d.cu``) share of its roofline in the profiled
request, at every grid level it runs on."""
from harness import roofline

KERNELS = (roofline.KernelSpec('pylabfea_tpu_torch.ops.volume:k_apply3',
                               'kapply3d_kernel', roofline.kapply3d_work),)


def read(ctx):
    return roofline.share(ctx, KERNELS[0])
