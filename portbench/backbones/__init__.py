"""The program's side of each backbone, one module per configuration's
"model", found by that name (``cells.backbone``); its reference side is
reference/backbones/<model>.py.  A module gives:

  MODEL          the program's ``Config.model`` that runs the backbone
  leaves(spec)   its weight leaves, (name, shape, kind, scale, offset) as
                 ``inputs.leaves`` has them, in the order they are drawn:
                 they lie between ``embed`` and ``out_b``
  width(spec)    the width of the hidden state that feeds the head
  build(cfg, w)  the program's backbone objects around the tensors of w,
                 as keyword arguments of ``fewshot_torch.models.lm.LM``:
                 every backbone argument of ``LM``, None where unused
  train_flops(spec, support_len, query_len)
                 the backbone's forward FLOPs over a train step's episodes
  sample_flops(spec, support_len, tokens)
                 the same over a sampling call's rows: the support pass and
                 the returned tokens (``counts/flops.py`` adds the head's)
  TINY           the CPU tests' tiny sizes (``tests/conftest.py``)
"""
