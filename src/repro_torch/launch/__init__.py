"""LM launch: step builders (:mod:`.steps`), the batched serving
launcher (:mod:`.serve`) and the training launcher (:mod:`.train`)."""
