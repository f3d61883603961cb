"""Many devices and many processes (counterpart of hibag_tpu/parallel/):
device lists that split the classifier axis, and process groups over
torch.distributed."""
