from terastructure_tpu_torch.data.dataset import EntrySet, GenotypeData  # noqa: F401
from terastructure_tpu_torch.data.pack import (  # noqa: F401
    pack2bit, packed_width, unpack2bit, unpack2bit_torch)
from terastructure_tpu_torch.data.simulate import (  # noqa: F401
    simulate_packed_device, simulate_psd)
