"""Kernel A's (``csrc/svc_fgrad.cu``) share of its roofline in the
profiled requests: a load history, or a run of return-map calls."""
from harness import roofline

KERNELS = (roofline.KernelSpec(
    'pylabfea_tpu_torch.ops.svc_kernels:svc_f_grad', 'svc_fgrad_kernel',
    roofline.svc_fgrad_work),)


def read(ctx):
    return roofline.share(ctx, KERNELS[0])
