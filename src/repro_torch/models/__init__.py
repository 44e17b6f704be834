"""The language models of the zoo (the port's copy of the reference's
`models` package): the attention families — dense, MoE, VLM and the
encoder-decoder — as `nn.Module`s that keep the reference's parameter
layout and leaf names. The recurrent families (Mamba2 hybrid, xLSTM) are
not ported yet (ROADMAP Queue A item 4)."""
