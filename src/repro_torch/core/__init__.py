# The HIR compiler core: IR, builder, verifier, passes, lowerings, gallery.
