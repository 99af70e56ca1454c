"""LM launch: step builders (:mod:`.steps`), the batched serving
launcher (:mod:`.serve`), the training launcher (:mod:`.train`), the
assigned input shapes (:mod:`.shapes`) and the analytic FLOPs / HBM-bytes
model (:mod:`.analytic`)."""
