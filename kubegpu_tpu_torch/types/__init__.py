"""The shared vocabulary of the port's device layer: its own copies of
the JAX package's ``types/`` (chips with mesh coordinates, grouped
resource paths, node/pod/container records and the annotation codec),
trimmed to what the device plugin, the advertiser and the CRI shim use.
The wire format is the system's own, byte for byte, so the JAX
package's extender reads what the port advertises."""
