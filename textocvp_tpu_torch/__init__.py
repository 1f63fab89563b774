"""textocvp_tpu_torch: the PyTorch/CUDA port of textocvp_tpu, for NVIDIA Hopper.

Serving path: SAVi seed encode (slot attention runs as a CUDA kernel on the
card), TextOCVP_T5 rollout and the spatial-broadcast decode, behind
``serve.PredictionService`` and its HTTP server. Importing the package starts
nothing and builds nothing; the kernel is compiled at its first launch.
"""
