"""LM serving launch: step builders (:mod:`.steps`) and the batched
serving launcher (:mod:`.serve`)."""
