"""LM launch: step builders (:mod:`.steps`), the batched serving
launcher (:mod:`.serve`), the training launcher (:mod:`.train`), the
assigned input shapes (:mod:`.shapes`), the analytic FLOPs / HBM-bytes
model (:mod:`.analytic`), the production meshes (:mod:`.mesh`), and the
dry run on a fake mesh (:mod:`.dryrun`) with its collective accounting
(:mod:`.comm_analysis`)."""
