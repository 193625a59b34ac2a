"""bbcat_dsp_tpu — a multi-channel audio DSP framework on JAX/XLA.

A brand-new framework (JAX / XLA / shard_map) with the capability surface
of the BBC's ``bbcat-dsp`` C++ library, rebuilt as batched array programs
for an accelerator rather than ported:

* sample-format conversion / dithering        (ref: src/SoundFormatConversions.*)
* ring / delay / multilayer buffering         (ref: src/SoundDelayBuffer.*, RingBuffer.h,
                                               MultilayerBuffer.h)
* mixing with click-free gain ramps           (ref: src/SoundMixing.*, Interpolator.h)
* RBJ biquad EQ, filter banks and cascades    (ref: src/BiQuad.*)
* all-pass filters and chains                 (ref: src/AllPassFilter.h)
* fractional-sample (polyphase sinc) delay    (ref: src/FractionalSample.*)
* running average / histogram analysis        (ref: src/RunningAverage.h, Histogram.h)
* partitioned FFT convolution w/ click-free   (ref: README:38-44 BlockConvolver /
  IR swap, multi-channel + matrix (HRTF)       Convolver — documented-absent in the
  convolvers                                   snapshot; built from spec)
* ITU-R BS.1770 multichannel loudness         (ref: README:65-66)
* SOFA (HRTF) file loading                    (ref: README:77-78)
* device-mesh sharding of channels/time with
  halo/crossfade collectives                  (new; no reference counterpart)

Design stance (see SURVEY.md §7): arrays not objects — all streaming state is
explicit pytrees threaded through pure ``(state, x) -> (state, y)`` functions;
canonical on-device layout is ``[..., channels, time]`` float32; sample formats
survive only at the host I/O edge.
"""

__version__ = "0.1.0"

from . import formats
from . import buffers
from . import ops
from . import convolve
from . import loudness
from . import filters
from . import parallel
from . import models
from . import analysis
from .register import register, loaded_versions

register()
