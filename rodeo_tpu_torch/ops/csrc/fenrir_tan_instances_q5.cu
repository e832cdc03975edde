// The instances of K11b (fenrir_backward_batch_tan.cuh) at q = 5, for 1 to
// kMaxTan tangent directions.
#include "fenrir_backward_batch_tan.cuh"

namespace rodeo {

template struct FenrirTanInstances<5>;

}  // namespace rodeo
