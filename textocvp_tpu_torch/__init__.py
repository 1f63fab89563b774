"""textocvp_tpu_torch: the PyTorch/CUDA port of textocvp_tpu, for NVIDIA Hopper.

Serving path: the seed encode of SAVi (CATER) or ExtendedDINOSAUR (CLIPort;
a frozen ViT whose attention runs as a CUDA kernel on the card), slot
attention (a CUDA kernel on the card), the TextOCVP_T5 rollout and the
model's decode (SAVi's decoder tail through a CUDA conv kernel), behind
``serve.PredictionService`` and its HTTP server. Evaluation: the 05
protocol on CATER, ``train.evaluator.PredictorEvaluator``. Importing the
package starts nothing and builds nothing; the kernels are compiled at the
first launch of any.
"""
