"""The distribution runtime's result codec (`service.pack_result`,
`service.unpack_result`), which the chunk store's entries share. The
master/worker runtime itself comes with the distribution slice."""
