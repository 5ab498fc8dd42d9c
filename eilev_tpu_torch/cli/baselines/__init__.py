"""The original EILeV's baselines (counterparts of ``scripts/baselines/``),
each run as ``python -m eilev_tpu_torch.cli.baselines.<name>``: the VideoMAE
verb/noun classifiers (``videomae_train``, ``videomae_predict``), the
majority-class baseline (``majority_predict``, needs spaCy), and the
sentence-ifiers of their predictions over ``TextLM``
(``videomae_generate_full_sent``, ``majority_generate_full_sent``)."""
