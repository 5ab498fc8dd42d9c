"""The CLIs of the port, each run as ``python -m eilev_tpu_torch.cli.<name>``:
``icl_eval`` (verb/noun ICL classification), ``generate_narration_texts``
(batched narration), ``train_v2`` and ``train_v1`` (training), ``serve``
(continuous batching), ``sample_in_context_examples`` (ICL maps),
``generation_eval`` and ``verify_quality`` (the metric suite and the
published-table gate), ``get_vision_model_embs`` (vision embeddings), and
``baselines.<name>`` (VideoMAE and the majority class). They take the
arguments of the JAX package's ``scripts/<name>.py`` plus ``--device``
(default ``cuda``). Each ``main(argv)`` loads what it needs, then calls
``run(args, ...)``, which takes the loaded model, tokenizer and in-memory
datasets as well."""
