"""Frozen copies of the port's plain physics (``gennet_tpu_torch/physics``:
constants, detector geometry, the analytic PSD, IMRPhenomD, whitening and
windows), with their imports made relative. The benchmark's reference
synthesises the template rows and the event from them, so that it takes
no table the program made. They import nothing of the program.
"""
