"""The user CLIs of the port, each run as ``python -m eilev_tpu_torch.cli.<name>``:
``icl_eval`` (verb/noun ICL classification), ``generate_narration_texts``
(batched narration) and ``train_v2`` (v2 training). They take the arguments
of the JAX package's ``scripts/<name>.py`` plus ``--device`` (default
``cuda``). Each ``main(argv)`` loads the model, the tokenizer and the
datasets, then calls ``run(args, model, tokenizer, datasets)``, which takes
in-memory datasets as well."""
