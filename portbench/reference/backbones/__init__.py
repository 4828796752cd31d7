"""The reference's side of each backbone, one module per configuration's
"model", found by that name (``cells.backbone(model, reference=True)``);
its program side is backbones/<model>.py.  Plain float32 PyTorch that
imports nothing of the program.  A module gives the backbone's hidden
states [rows, positions, width] for the two call sites of
``reference/model.py``:

  episode_hidden(p, spec, support, support_len, inputs, in_mask, rnd)
      the query inputs [B, Q, L-1] (in_mask: their real positions)
      conditioned on the support songs [B, K, L]: [B*Q, L-1, D]
  served_hidden(p, spec, support, support_len, inputs, rnd)
      the served rows' inputs [R, n] (BOS, then the tokens before each
      position) conditioned on each row's support [R, K, L]: [R, n, D]

``rnd`` rounds every operand of a product that the configuration runs at
its compute dtype (``model.exact`` or ``model.fp8``).
"""
