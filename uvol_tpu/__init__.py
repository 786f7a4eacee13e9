"""uvol_tpu — a JAX framework for 4D volumetric video.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of
EtherealEngine/Universal-Volumetric (UVOL): a compressed interchange format,
encoder, and streaming player for time sequences of textured triangle meshes.

Layer map (mirrors SURVEY.md §1):
  L0  entropy/bit codecs        uvol_tpu.codecs.{rans,tunstall,bitstream}
  L1  attribute codecs          uvol_tpu.ops.{quantize,prediction,normals}
  L2  frame codecs              uvol_tpu.codecs.{draco,corto,basis}
  L3  sequence encoder / CLI    uvol_tpu.encoder_cli, uvol_tpu.models.sequence
  L4  containers & manifests    uvol_tpu.containers.{manifest,drcs,ktx2}
  L5  decode services           uvol_tpu.runtime (batched/jit decode, host pools)
  L6  streaming players         uvol_tpu.player.{v1,v2}
  L7  facade                    uvol_tpu.player.facade.Player
  L8  apps                      examples/

The compute path is pure JAX (jit/vmap/Pallas, sharded over a device Mesh);
sequential bit-exact serialization lives in numpy/C++ on the host.
"""

__version__ = "0.1.0"

from uvol_tpu.interfaces import (  # noqa: F401
    FORMATS_TO_EXT,
    TEXTURE_FORMAT_PRIORITY,
    GeometryTarget,
    KTX2TextureTarget,
    PlayMode,
    TextureTarget,
    V1FrameData,
    V1Schema,
    V2Schema,
)
