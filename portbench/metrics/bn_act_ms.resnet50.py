"""Device ms a step of the elementwise and reduction kernels: batch norm,
ReLU, the residual adds and the casts of the port's plain-torch layers
(the classes of the ResNet step's profile; the optimizer's
multi_tensor_apply kernels are not among them)."""

from portbench.readers import class_ms

#: PyTorch's elementwise, copy and reduction kernels
PATTERNS = (r"elementwise", r"copy_kern", r"direct_copy", r"reduce_kernel",
            r"batch_norm", r"bn_fw", r"bn_bw")
EXCLUDE = r"multi_tensor_apply"


def read(ctx):
    return class_ms(ctx, PATTERNS, exclude=EXCLUDE)
