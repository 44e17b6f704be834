"""The language models of the zoo (the port's copy of the reference's
`models` package): dense, MoE, VLM, the encoder-decoder, the Mamba2 hybrid
and the xLSTM, as `nn.Module`s that keep the reference's parameter layout
and leaf names."""
