"""The Ego4D data tools (counterparts of ``scripts/ego4d/``), each run as
``python -m eilev_tpu_torch.cli.ego4d.<name>``: ``extract_frames`` (clips ->
resized frames + ``narrated_actions.csv``), ``split_train_val_test`` (the
video-level split of fho_main), ``add_structured_verb_noun`` (backfill the
structured columns) and ``generate_std_sent`` (standard sentences through
``TextLM``)."""
