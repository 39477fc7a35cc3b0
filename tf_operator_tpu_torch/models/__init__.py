"""The port's model stack: Llama, paged KV, paged attention, serving."""
