"""Kernel B's (``csrc/kapply2d.cu``) share of its roofline in the profiled
request, at every grid level it runs on."""
from harness import roofline

KERNELS = (roofline.KernelSpec('pylabfea_tpu_torch.ops.stencil:k_apply',
                               'kapply2d_kernel', roofline.kapply2d_work),)


def read(ctx):
    return roofline.share(ctx, KERNELS[0])
